"""P — pretty-printer (reference Interpreter/Print.hs).

Same output conventions: `(\\vN -> body)` with indices growing outside-in,
application as juxtaposition, hints/keys as `<HINT>`/`<KEY>`, linear
functions as `<FUNC>` (Print.hs:45-49, 121-142).

A copy of `alchemy_tpu/interp/pprint.py`.
"""

from __future__ import annotations

from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var

_PRIM_NAMES = {
    "add_": "add",
    "neg_": "neg",
    "mul_": "mul",
    "div2_": "div2",
    "modSwitchPT_": "modSwitchPT",
    "modSwitch_": "modSwitch",
    "nil_": "nil",
    "cons_": "cons",
    "pair_": "pair",
    "fst_": "fst",
    "snd_": "snd",
}


def _prim_str(node: Prim) -> str:
    n = node.name
    if n in _PRIM_NAMES:
        return _PRIM_NAMES[n]
    if n == "addLit_":
        return f"addLit ({node.payload})"
    if n == "mulLit_":
        return f"mulLit ({node.payload})"
    if n == "addPublic_":
        return f"addPublic ({node.payload})"
    if n == "mulPublic_":
        return f"mulPublic ({node.payload})"
    if n == "keySwitchQuad_":
        return "keySwitchQuad <HINT>"
    if n == "tunnel_":
        return "tunnel <HINT>"
    if n == "linearCyc_":
        return "linearCyc <FUNC>"
    if n == "errorRate_":
        return "errorRate <KEY>"
    if n == "string_":
        return str(node.payload)
    if n == "tellEntries_":
        return "tellError <KEY>"
    if n in ("fmap_", "pure_", "ap_", "bind_", "tell_", "listen_"):
        return n[:-1]
    return n


def _pp(node: Node, depth: int) -> str:
    if isinstance(node, Lam):
        return f"(\\v{depth} -> {_pp(node.body, depth + 1)})"
    if isinstance(node, App):
        return f"({_pp(node.f, depth)} {_pp(node.a, depth)})"
    if isinstance(node, Var):
        return f"v{depth - 1 - node.idx}"
    if isinstance(node, Prim):
        return _prim_str(node)
    raise TypeError(node)


def pprint(expr: Node) -> str:
    return _pp(expr, 0)
