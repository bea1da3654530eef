"""pNoise/type inference over plaintext expressions.

This pass reifies what GHC's typechecker does for the reference (SURVEY.md
§3.2 "compilation IS typeclass instance resolution"): starting from the
declared result type, it propagates `PtTy(pnoise, m, zp)` through the term,
applying the Pre* input-type families at `mul_` (PT2CT.hs:163-164), `div2_`
(:185-187) and `linearCyc_` (:209-210), and unifying at binders.

Implemented as lazy one-pass constraint propagation: every node gets a TRef
cell; rules fire as types become known (order-independent, so let-bound
values are typed by their use sites exactly as Haskell inference would).

A copy of `alchemy_tpu/interp/infer.py`.
"""

from __future__ import annotations

from alchemy_tpu_torch.interp.noise import TUNNEL_PNOISE, FunTy, NoiseLedger, PtTy
from alchemy_tpu_torch.lang.ir import App, FreeVar, Lam, Node, Prim, Var


class TRef:
    __slots__ = ("ty", "_cbs")

    def __init__(self):
        self.ty = None
        self._cbs = []

    def set(self, ty):
        if self.ty is not None:
            _unify_concrete(self.ty, ty)
            return
        self.ty = ty
        cbs, self._cbs = self._cbs, []
        for cb in cbs:
            cb(ty)

    def on_set(self, cb):
        if self.ty is not None:
            cb(self.ty)
        else:
            self._cbs.append(cb)


def _unify_concrete(a, b):
    if isinstance(a, PtTy) and isinstance(b, PtTy):
        if a != b:
            raise TypeError(f"type mismatch: {a} vs {b}")
        return
    if isinstance(a, FunTy) and isinstance(b, FunTy):
        unify(a.arg, b.arg)
        unify(a.res, b.res)
        return
    raise TypeError(f"type mismatch: {a} vs {b}")


def unify(a: TRef, b: TRef):
    if a is b:
        return
    a.on_set(b.set)
    b.on_set(a.set)


def fun(arg: TRef, res: TRef) -> TRef:
    t = TRef()
    t.set(FunTy(arg, res))
    return t


class Inference:
    def __init__(self, ledger: NoiseLedger):
        self.ledger = ledger
        self.types: dict[int, TRef] = {}

    def tref(self, node: Node) -> TRef:
        return self.types.setdefault(node.uid, TRef())

    def run(self, root: Node, res_ty: PtTy) -> None:
        self._visit(root, [])
        node = root
        while isinstance(node, Lam):
            node = node.body
        self.tref(node).set(res_ty)

    def resolved(self, node: Node):
        t = self.tref(node).ty
        if t is None:
            raise TypeError(f"inference could not resolve the type of {node!r}")
        return t

    def resolved_pt(self, ref: TRef) -> PtTy:
        if ref.ty is None or not isinstance(ref.ty, PtTy):
            raise TypeError(f"unresolved or non-ground type: {ref.ty!r}")
        return ref.ty

    # ------------------------------------------------------------------

    def _visit(self, node: Node, env: list[TRef]):
        t = self.tref(node)
        if isinstance(node, Var):
            unify(t, env[node.idx])
        elif isinstance(node, Lam):
            arg = TRef()
            self._visit(node.body, [arg] + env)
            t.set(FunTy(arg, self.tref(node.body)))
        elif isinstance(node, App):
            self._visit(node.f, env)
            self._visit(node.a, env)
            self.tref(node.f).set(FunTy(self.tref(node.a), t))
        elif isinstance(node, Prim):
            self._prim_rule(node, t)
        elif isinstance(node, FreeVar):
            raise TypeError("unbound FreeVar escaped lam()")
        else:
            raise TypeError(f"infer: unexpected node {node!r}")

    def _prim_rule(self, node: Prim, t: TRef):
        n = node.name
        led = self.ledger
        if n in ("add_",):
            a = TRef()
            t.set(FunTy(a, fun(a, a)))
        elif n in ("neg_", "addLit_", "mulLit_"):
            a = TRef()
            t.set(FunTy(a, a))
        elif n == "mul_":
            a_in, a_out = TRef(), TRef()
            t.set(FunTy(a_in, fun(a_in, a_out)))
            # top-down only: mul_input_pnoise is not injective (prefix
            # quantization), so the output→input family has no usable inverse
            a_out.on_set(
                lambda p: a_in.set(PtTy(led.mul_input_pnoise(p.pnoise), p.m, p.zp))
            )
        elif n == "div2_":
            a_in, a_out = TRef(), TRef()
            t.set(FunTy(a_in, a_out))
            a_out.on_set(lambda p: a_in.set(PtTy(p.pnoise, p.m, p.zp * 2)))
            a_in.on_set(lambda p: a_out.set(PtTy(p.pnoise, p.m, p.zp // 2)))
        elif n == "linearCyc_":
            f = node.payload
            a_in, a_out = TRef(), TRef()
            t.set(FunTy(a_in, a_out))
            a_out.on_set(
                lambda p: (
                    _expect(p.m == f.s, f"linearCyc output ring {p.m} != {f.s}"),
                    a_in.set(PtTy(p.pnoise + TUNNEL_PNOISE, f.r, p.zp)),
                )
            )
            a_in.on_set(
                lambda p: (
                    _expect(p.m == f.r, f"linearCyc input ring {p.m} != {f.r}"),
                    a_out.set(PtTy(p.pnoise - TUNNEL_PNOISE, f.s, p.zp)),
                )
            )
        else:
            raise TypeError(f"infer: primitive {n!r} is not a plaintext op")


def _expect(cond: bool, msg: str):
    if not cond:
        raise TypeError(msg)
