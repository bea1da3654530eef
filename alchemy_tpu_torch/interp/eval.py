"""E — the metacircular evaluator (reference Interpreter/Eval.hs).

Evaluates the IR over concrete values: plaintext `Cyc`s, ciphertext `CT`s,
Python functions (for lambda values), lists/pairs/strings. Each primitive
maps 1:1 to the ring/SHE function of the same meaning — the op↔semantics
table of Eval.hs:120-160.

A copy of `alchemy_tpu/interp/eval.py`, except the ERW probe: on a torch
backend it runs on the device (she/noise_probe.py), any other backend takes
the host probe `bgv.error_rate`.
"""

from __future__ import annotations

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.lang.ir import App, Lam, Node, Prim, Var
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.tunnel import tunnel as tunnel_apply


def pt_div2(c: Cyc) -> Cyc:
    """Plaintext div2 (Lol `rescalePow`, Eval.hs:72-88): halve a value known
    to be even, Z_{2^{k+1}} → Z_{2^k}. Exact for even inputs; rounds down
    otherwise (undefined behavior in the reference too)."""
    p = c.qs[0]
    assert p % 2 == 0 and p > 2
    arr = c.bk.to_numpy(c.to_pow().data)[0]
    return Cyc.from_coeffs(c.m, (p // 2,), arr // 2, c.bk)


def _lit_to_cyc(lit, like: Cyc) -> Cyc:
    if isinstance(lit, Cyc):
        return lit
    return Cyc.constant(like.m, like.qs, int(lit), like.bk)


def _curry2(f):
    return lambda a: lambda b: f(a, b)


def _prim_value(name: str, payload):
    if name == "add_":
        return _curry2(lambda a, b: bgv.add(a, b) if isinstance(a, CT) else a + b)
    if name == "neg_":
        return lambda a: bgv.neg(a) if isinstance(a, CT) else -a
    if name == "mul_":
        return _curry2(lambda a, b: bgv.mul(a, b) if isinstance(a, CT) else a * b)
    if name == "addLit_":
        return lambda a: _lit_to_cyc(payload, a) + a
    if name == "mulLit_":
        return lambda a: _lit_to_cyc(payload, a) * a
    if name == "div2_":
        return lambda a: bgv.mod_switch_pt(a) if isinstance(a, CT) else pt_div2(a)
    if name == "linearCyc_":
        return lambda a: payload.eval(a)
    if name == "modSwitchPT_":
        return bgv.mod_switch_pt
    if name == "modSwitch_":
        return lambda ct: bgv.mod_switch(ct, payload["new_qs"])
    if name == "addPublic_":
        return lambda ct: bgv.add_public(payload, ct)
    if name == "mulPublic_":
        return lambda ct: bgv.mul_public(payload, ct)
    if name == "keySwitchQuad_":
        return lambda ct: bgv.key_switch_quad(payload, ct)
    if name == "tunnel_":
        return lambda ct: tunnel_apply(payload, ct)
    if name == "errorRate_":
        return lambda ct: bgv.error_rate(payload, ct)
    if name == "tellEntries_":
        # ERW probe (interp/error_writer.py): the object-language tellError
        # of ErrorRateWriter.hs:70-75 — [(op ++ modulus, rate)] or [] when
        # the value is not a ciphertext / no key is known
        opname, ctx, strict = payload

        def probe(v):
            if not isinstance(v, CT):
                return []
            sk = ctx.lookup_key(v.m_prime)
            if sk is None:
                return []
            label = f"{opname}Zq[" + ",".join(str(q) for q in v.qs) + "]"
            if ctx.bk.name == "torch":
                # device-resident probe (she/noise_probe.py): the O(n) lift
                # runs on the ciphertext's device. Strict mode reads the [L]
                # digit vector back here, so an overflow raises at this op;
                # otherwise it stays on the device and resolve_log reads
                # every deferred vector back in one copy after the run
                from alchemy_tpu_torch.she.noise_probe import (
                    DeferredRate,
                    error_digits,
                )

                entry = DeferredRate(error_digits(sk, v), v.qs)
                if not strict:
                    return [(label, entry)]
                rate = entry.resolve()
            else:
                rate = bgv.error_rate(sk, v)
            if strict:
                from alchemy_tpu_torch.interp.error_writer import (
                    NOISE_OVERFLOW_THRESHOLD,
                    NoiseOverflowError,
                )
                if rate > NOISE_OVERFLOW_THRESHOLD:
                    raise NoiseOverflowError(
                        f"{label}: error rate {rate:.3g} exceeds "
                        f"{NOISE_OVERFLOW_THRESHOLD}"
                    )
            return [(label, rate)]

        return probe
    if name == "nil_":
        return []
    if name == "cons_":
        return _curry2(lambda a, b: [a] + b)
    if name == "pair_":
        return _curry2(lambda a, b: (a, b))
    if name == "fst_":
        return lambda p: p[0]
    if name == "snd_":
        return lambda p: p[1]
    if name == "string_":
        return payload
    if name in _MONAD_PRIMS:
        return _MONAD_PRIMS[name](payload)
    raise ValueError(f"eval: unknown primitive {name!r}")


# Object-language monad primitives (reference Language/Monad.hs; Eval.hs
# instances 101-118). Monads are represented structurally:
#   writer: (value, log_list)   reader: unary function   list: Python list
def _monad_fmap(m):
    def go(f):
        def on(v):
            if m == "writer":
                return (f(v[0]), v[1])
            if m == "reader":
                return lambda r: f(v(r))
            return [f(x) for x in v]
        return on
    return go


def _monad_pure(m):
    if m == "writer":
        return lambda a: (a, [])
    if m == "reader":
        return lambda a: (lambda _r: a)
    return lambda a: [a]


def _monad_ap(m):
    def go(mf):
        def on(ma):
            if m == "writer":
                return (mf[0](ma[0]), mf[1] + ma[1])
            if m == "reader":
                return lambda r: mf(r)(ma(r))
            return [f(a) for f in mf for a in ma]
        return on
    return go


def _monad_bind(m):
    def go(ma):
        def on(k):
            if m == "writer":
                b = k(ma[0])
                return (b[0], ma[1] + b[1])
            if m == "reader":
                return lambda r: k(ma(r))(r)
            return [b for a in ma for b in k(a)]
        return on
    return go


_MONAD_PRIMS = {
    "fmap_": _monad_fmap,
    "pure_": _monad_pure,
    "ap_": _monad_ap,
    "bind_": _monad_bind,
    "tell_": lambda _m: (lambda w: (None, list(w))),
    "listen_": lambda _m: (lambda ma: ((ma[0], ma[1]), ma[1])),
    "ask_": lambda _m: (lambda r: r),
    "local_": lambda _m: (lambda f: lambda ma: lambda r: ma(f(r))),
}


def _eval(node: Node, env: tuple):
    if isinstance(node, Var):
        return env[node.idx]
    if isinstance(node, Lam):
        return lambda v: _eval(node.body, (v,) + env)
    if isinstance(node, App):
        return _eval(node.f, env)(_eval(node.a, env))
    if isinstance(node, Prim):
        return _prim_value(node.name, node.payload)
    raise TypeError(f"eval: unexpected node {node!r}")


def eval_ir(expr: Node, *args):
    """Evaluate a closed expression, applying it to `args` (Eval.hs:46)."""
    v = _eval(expr, ())
    for a in args:
        v = v(a)
    return v
