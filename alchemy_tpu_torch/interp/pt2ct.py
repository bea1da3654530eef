"""PT2CT — the plaintext→ciphertext compiler (reference Interpreter/PT2CT.hs).

Pipeline (the reification of SURVEY.md §3.2):
1. pNoise inference from the declared result type (interp/infer.py);
2. modulus assignment per op via the noise ledger (interp/noise.py);
3. key/hint planning against the KeysHints cache;
4. op rewriting with the reference's exact compile rules:
   - add_/neg_ unchanged (PT2CT.hs:114-118)
   - addLit_/mulLit_ → addPublic_/mulPublic_ (:120-130)
   - mul_ → λx y. modSwitch(out) ∘ keySwitchQuad(hint) ∘ modSwitch(hint) (x·y)
     (:160-177)
   - div2_ → modSwitchPT_ (:179-189)
   - linearCyc_ f → λx. modSwitch(out) ∘ tunnel(hint) ∘ modSwitch(hint) x
     (:207-229)

A copy of `alchemy_tpu/interp/pt2ct.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.interp.infer import Inference
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import FunTy, NoiseLedger, PtTy
from alchemy_tpu_torch.lang import dsl
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.gadget import Gadget


def _zq_ann(qs: tuple[int, ...]) -> str:
    return "Zq[" + ",".join(str(q) for q in qs) + "]"


@dataclass
class CompiledExpr:
    """Result of pt2ct: the ciphertext IR plus the typing needed at the
    encryption boundary."""

    ir: Node
    arg_tys: tuple[PtTy, ...]
    res_ty: PtTy
    m_map: dict[int, int]
    ledger: NoiseLedger
    gad: Gadget
    ctx: KeysHints

    def arg_qs(self, i: int) -> tuple[int, ...]:
        return self.ledger.qs_for_pnoise(self.arg_tys[i].pnoise)

    def encrypt_arg(self, pt: Cyc, i: int = 0) -> CT:
        """Encrypt a plaintext for argument slot i (PT2CT.hs:76-88: the
        ciphertext modulus is the one the compiled function expects)."""
        ty = self.arg_tys[i]
        assert pt.m == ty.m and pt.qs == (ty.zp,), (pt, ty)
        return self.ctx.encrypt(pt, self.m_map[ty.m], self.arg_qs(i))

    def decrypt(self, ct: CT):
        return self.ctx.decrypt(ct)


def pt2ct(
    expr: Node,
    *,
    res_ty: PtTy,
    m_map: dict[int, int],
    zqs: RnsChain,
    gad: Gadget,
    ctx: KeysHints,
) -> CompiledExpr:
    # parameter validation (the reference's compile-time TypeErrors,
    # Noise.hs:142-151 / config-as-types of SURVEY.md §5)
    from alchemy_tpu_torch.nt.primes import validate_moduli_for_ring

    for m, m_prime in m_map.items():
        if m_prime % m != 0:
            raise ValueError(f"m'-map entry {m}→{m_prime}: {m} must divide {m_prime}")
        validate_moduli_for_ring(m_prime, list(zqs.qs))
    for q in zqs.qs:
        if q <= (1 << 16):
            raise ValueError(f"modulus {q} too small: backends require q > 2^16")

    ledger = NoiseLedger(zqs)
    inf = Inference(ledger)
    inf.run(expr, res_ty)

    c = _Compiler(inf, ledger, m_map, gad, ctx)
    out_ir = c.compile(expr)

    # argument types from the root function type
    arg_tys = []
    t = inf.tref(expr).ty
    while isinstance(t, FunTy):
        arg_tys.append(inf.resolved_pt(t.arg))
        t = t.res.ty
    return CompiledExpr(out_ir, tuple(arg_tys), res_ty, dict(m_map), ledger, gad, ctx)


class _Compiler:
    def __init__(self, inf: Inference, ledger: NoiseLedger, m_map, gad: Gadget, ctx: KeysHints):
        self.inf = inf
        self.ledger = ledger
        self.m_map = dict(m_map)
        self.gad = gad
        self.ctx = ctx

    def _mp(self, m: int) -> int:
        if m not in self.m_map:
            raise ValueError(f"Could not find {m} in the m'-map (Lookup, PT2CT.hs:272-276)")
        return self.m_map[m]

    def compile(self, node: Node) -> Node:
        if isinstance(node, Var):
            return Var(node.idx)
        if isinstance(node, Lam):
            return Lam(self.compile(node.body))
        if isinstance(node, App):
            return App(self.compile(node.f), self.compile(node.a))
        if isinstance(node, Prim):
            return self._compile_prim(node)
        raise TypeError(node)

    # ------------------------------------------------------------------

    def _prim_tys(self, node: Prim):
        """(arg_ty, res_ty) of a unary prim / (arg, arg, res) of add/mul."""
        t = self.inf.resolved(node)
        assert isinstance(t, FunTy)
        return t

    def _compile_prim(self, node: Prim) -> Node:
        n = node.name
        led = self.ledger
        t = self._prim_tys(node)
        if n == "add_":
            a = self.inf.resolved_pt(t.arg)
            return Prim("add_", ann={"zq": _zq_ann(led.qs_for_pnoise(a.pnoise))})
        if n == "neg_":
            a = self.inf.resolved_pt(t.arg)
            return Prim("neg_", ann={"zq": _zq_ann(led.qs_for_pnoise(a.pnoise))})
        if n in ("addLit_", "mulLit_"):
            a = self.inf.resolved_pt(t.arg)
            lit = node.payload
            if not isinstance(lit, Cyc):
                lit = Cyc.constant(a.m, (a.zp,), int(lit), self.ctx.bk)
            assert lit.m == a.m and lit.qs == (a.zp,)
            out_name = "addPublic_" if n == "addLit_" else "mulPublic_"
            return Prim(out_name, lit, ann={"zq": _zq_ann(led.qs_for_pnoise(a.pnoise))})
        if n == "mul_":
            # t = pin -> (pin -> p)
            pin = self.inf.resolved_pt(t.arg)
            p = self.inf.resolved_pt(t.res.ty.res)
            m_p = self._mp(p.m)
            in_qs = led.qs_for_pnoise(pin.pnoise)
            hint_qs = led.hint_qs(self.gad, p.pnoise)
            out_qs = led.qs_for_pnoise(p.pnoise)
            hint = self.ctx.get_quad_circ_hint(m_p, hint_qs, self.gad, p.zp)
            mul_prim = Prim("mul_", ann={"zq": _zq_ann(in_qs)})
            ks = Prim("keySwitchQuad_", hint, ann={"zq": _zq_ann(hint_qs)})
            ms_in = Prim("modSwitch_", {"new_qs": hint_qs},
                         ann={"zq": f"{_zq_ann(in_qs)} -> {_zq_ann(hint_qs)}"})
            ms_out = Prim("modSwitch_", {"new_qs": out_qs},
                          ann={"zq": f"{_zq_ann(hint_qs)} -> {_zq_ann(out_qs)}"})
            return dsl.lam2(
                lambda x, y: App(ms_out, App(ks, App(ms_in, App(App(mul_prim, x), y))))
            )
        if n == "div2_":
            p = self.inf.resolved_pt(t.res)
            return Prim("modSwitchPT_", ann={"zq": _zq_ann(led.qs_for_pnoise(p.pnoise))})
        if n == "linearCyc_":
            f = node.payload
            pin = self.inf.resolved_pt(t.arg)
            p = self.inf.resolved_pt(t.res)
            in_qs = led.qs_for_pnoise(pin.pnoise)
            hint_qs = led.hint_qs(self.gad, p.pnoise)
            out_qs = led.qs_for_pnoise(p.pnoise)
            hint = self.ctx.get_tunnel_hint(
                f, self._mp(f.r), self._mp(f.s), hint_qs, self.gad, p.zp
            )
            tun = Prim("tunnel_", hint, ann={"zq": _zq_ann(hint_qs)})
            ms_in = Prim("modSwitch_", {"new_qs": hint_qs},
                         ann={"zq": f"{_zq_ann(in_qs)} -> {_zq_ann(hint_qs)}"})
            ms_out = Prim("modSwitch_", {"new_qs": out_qs},
                          ann={"zq": f"{_zq_ann(hint_qs)} -> {_zq_ann(out_qs)}"})
            return dsl.lam(lambda x: App(ms_out, App(tun, App(ms_in, x))))
        raise TypeError(f"pt2ct: cannot compile primitive {n!r}")
