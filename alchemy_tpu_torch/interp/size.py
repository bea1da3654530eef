"""S — AST size (reference Interpreter/Size.hs: every op counts 1,
lam = body+1, app = f+a)."""

from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var


def size(expr: Node) -> int:
    if isinstance(expr, Lam):
        return 1 + size(expr.body)
    if isinstance(expr, App):
        return size(expr.f) + size(expr.a)
    if isinstance(expr, (Var, Prim)):
        return 1
    raise TypeError(expr)
