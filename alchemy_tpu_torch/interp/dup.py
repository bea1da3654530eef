"""Dup — product interpreter (reference Interpreter/Dup.hs:18-27).

With a reified IR, interpreting one term two ways is sharing the tree:
`dup` returns the same IR twice, so `eval`, `pprint`, `size`, `params` can
each consume "their copy" exactly as the reference splits one compiled AST
into four interpreters (examples/Arithmetic.hs:52-64)."""

from alchemy_tpu_torch.lang.ir import Node


def dup(expr: Node) -> tuple[Node, Node]:
    return expr, expr
