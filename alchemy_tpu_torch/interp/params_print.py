"""Params — per-op parameter introspection (reference Interpreter/Params.hs).

For plaintext expressions: prints each op with the pNoise it was assigned
(showPNoise, Params.hs:50-51,57-77). For compiled ciphertext expressions:
prints each op with its ciphertext modulus, and `modSwitch from -> to`
(showZq, Params.hs:47-48,79-117). One op per line, application order,
blank lines collapsed (Params.hs:36-44).

A copy of `alchemy_tpu/interp/params_print.py`.
"""

from __future__ import annotations

from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.interp.infer import Inference
from alchemy_tpu_torch.interp.noise import FunTy, NoiseLedger, PtTy
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var

_DISPLAY = {
    "add_": "add",
    "neg_": "neg",
    "mul_": "mul",
    "div2_": "div2",
    "addLit_": "addLit",
    "mulLit_": "mulLit",
    "linearCyc_": "linear",
    "modSwitch_": "modSwitch",
    "modSwitchPT_": "modSwitchPT",
    "keySwitchQuad_": "keySwitchQuad",
    "addPublic_": "addPublic",
    "mulPublic_": "mulPublic",
    "tunnel_": "tunnel",
    "errorRate_": "errorRate",
}


def _collect(node: Node, lines: list[str], pt_info) -> None:
    if isinstance(node, Lam):
        _collect(node.body, lines, pt_info)
    elif isinstance(node, App):
        _collect(node.f, lines, pt_info)
        _collect(node.a, lines, pt_info)
    elif isinstance(node, Prim):
        disp = _DISPLAY.get(node.name, node.name)
        if node.ann and "zq" in node.ann:
            lines.append(f"{disp} {node.ann['zq']}")
        elif pt_info is not None:
            inf = pt_info
            t = inf.tref(node).ty
            # show the pnoise of the op's characteristic (output) type
            ref = t
            while isinstance(ref, FunTy):
                ref = ref.res.ty
            if isinstance(ref, PtTy):
                lines.append(f"{disp} {ref.pnoise}")
            else:
                lines.append(disp)
        else:
            lines.append(disp)
    # Var prints nothing (Params.hs:44)


def params(expr: Node, *, res_ty: PtTy | None = None, zqs: RnsChain | None = None) -> str:
    """Parameter dump. For plaintext expressions pass res_ty and zqs (the
    analog of `params @(PT2CT M'Map Zqs ...)`, examples/Arithmetic.hs:48)."""
    pt_info = None
    if res_ty is not None:
        assert zqs is not None
        pt_info = Inference(NoiseLedger(zqs))
        pt_info.run(expr, res_ty)
    lines: list[str] = []
    _collect(expr, lines, pt_info)
    return "\n".join(lines)
