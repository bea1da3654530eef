"""The port's compiler and evaluators against the JAX package: `pt2ct`,
`KeysHints`, `eval_ir` and `eval_with_error_rates` at one seed on the
Arithmetic program. The JAX package runs on its golden backend, the port on
`TorchBackend(device="cpu")` and on its golden backend: every hint, encrypted
argument and result ciphertext must be equal, and every error-rate log equal
float for float. Also the device noise probe (`she/noise_probe.py`) against
the host probe and the JAX package's probe, `resolve_log`, and strict mode
raising at the same op in both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import alchemy_tpu.examples.arithmetic as jarith
from alchemy_tpu.backend import golden_backend as jgolden
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.interp import error_writer as jerw
from alchemy_tpu.interp.eval import eval_ir as jeval_ir
from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
from alchemy_tpu.lang.ir import App as JApp, Lam as JLam, Prim as JPrim
from alchemy_tpu.she import bgv as jbgv
from alchemy_tpu.she.gadget import TrivGad as JTrivGad
import alchemy_tpu_torch.examples.arithmetic as tarith
from alchemy_tpu_torch.backend import golden_backend as tgolden
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc as TCyc
from alchemy_tpu_torch.interp import error_writer as terw
from alchemy_tpu_torch.interp.eval import eval_ir as teval_ir
from alchemy_tpu_torch.interp.keys_hints import KeysHints as TKeysHints
from alchemy_tpu_torch.interp.pt2ct import pt2ct as tpt2ct
from alchemy_tpu_torch.lang.ir import App as TApp, Lam as TLam, Prim as TPrim
from alchemy_tpu_torch.she import bgv as tbgv
from alchemy_tpu_torch.she import noise_probe
from alchemy_tpu_torch.she.gadget import TrivGad as TTrivGad

JAX = dict(arith=jarith, Cyc=JCyc, erw=jerw, eval_ir=jeval_ir, KeysHints=JKeysHints,
           pt2ct=jpt2ct, App=JApp, Lam=JLam, Prim=JPrim, bgv=jbgv, TrivGad=JTrivGad)
PORT = dict(arith=tarith, Cyc=TCyc, erw=terw, eval_ir=teval_ir, KeysHints=TKeysHints,
            pt2ct=tpt2ct, App=TApp, Lam=TLam, Prim=TPrim, bgv=tbgv, TrivGad=TTrivGad)
SEED = 5


def _bk(name):
    return {"golden": tgolden, "torch-cpu": lambda: TorchBackend(device="cpu")}[name]()


def _flat(x):
    """Any structure of Cycs, CTs, hints, gadgets and plain values →
    comparable plain values (residues as lists)."""
    if hasattr(x, "comps"):
        return ("CT", x.m, x.zp, x.scale, x.m_prime, x.qs, [_flat(c) for c in x.comps])
    if hasattr(x, "basis") and hasattr(x, "data"):
        return ("Cyc", x.m, x.qs, x.basis, x.bk.to_numpy(x.data).tolist())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                [(f.name, _flat(getattr(x, f.name))) for f in dataclasses.fields(x)])
    if isinstance(x, (tuple, list)):
        return [_flat(v) for v in x]
    if isinstance(x, dict):
        return sorted((k, _flat(v)) for k, v in x.items())
    if isinstance(x, np.ndarray):
        return x.tolist()
    assert x is None or isinstance(x, (int, float, str, bool)), type(x)
    return x


def _payloads(ns, node):
    """Payloads of the compiled program's primitives, in tree order."""
    if isinstance(node, ns["Lam"]):
        return _payloads(ns, node.body)
    if isinstance(node, ns["App"]):
        return _payloads(ns, node.f) + _payloads(ns, node.a)
    if isinstance(node, ns["Prim"]) and node.payload is not None:
        return [(node.name, node.payload)]
    return []


def _arith_setup(ns, bk, seed=SEED):
    a = ns["arith"]
    rng = np.random.default_rng(seed)
    pts = [ns["Cyc"].from_coeffs(a.M, (a.ZP,), rng.integers(0, a.ZP, 2), bk) for _ in range(2)]
    ctx = ns["KeysHints"](3.0, seed=seed, bk=bk)
    compiled = ns["pt2ct"](a.addMul, res_ty=a.PT, m_map=a.M_MAP, zqs=a.ZQS, gad=ns["TrivGad"](),
                           ctx=ctx)
    args = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]
    return ctx, compiled, pts, args


def arith_script(ns, bk):
    """Compile, encrypt, evaluate plainly and under ERW (lenient and
    strict), decrypt: every value recorded in order."""
    ctx, compiled, pts, args = _arith_setup(ns, bk)
    out = [("hints", [(_flat(k), _flat(v)) for k, v in ctx.hints.items()]),
           ("payloads", [(k, _flat(v)) for k, v in _payloads(ns, compiled.ir)]),
           ("args", [_flat(c) for c in args])]
    res = ns["eval_ir"](compiled.ir, *args)
    res_erw, log = ns["erw"].eval_with_error_rates(compiled.ir, ctx, *args)
    res_strict, log_strict = ns["erw"].eval_with_error_rates(compiled.ir, ctx, *args, strict=True)
    dec = compiled.decrypt(res)
    out += [("result", _flat(res)), ("result erw", _flat(res_erw)),
            ("result strict", _flat(res_strict)), ("log", log), ("log strict", log_strict),
            ("decrypt", _flat(dec)), ("ok", dec.equals((pts[0] + pts[1]) * pts[1])),
            ("host rates", [ns["bgv"].error_rate(ctx.lookup_key(c.m_prime), c)
                            for c in (*args, res)])]
    return out


@pytest.mark.parametrize("bk", ["torch-cpu", "golden"])
def test_compile_and_evaluate_match_jax(bk):
    want = arith_script(JAX, jgolden())
    got = arith_script(PORT, _bk(bk))
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, w), (_, g) in zip(want, got):
        assert g == w, k
    log = dict(got)["log"]
    assert [label for label, _ in log] == [
        "add_Zq[268440577,8392193]", "mul_Zq[268440577,8392193]",
        "modSwitch_Zq[268440577,8392193]", "keySwitchQuad_Zq[268440577,8392193]",
        "modSwitch_Zq[268440577]"]
    assert all(isinstance(r, float) and 0 < r < 1e-4 for _, r in log)
    assert dict(got)["ok"]


def _noisy_script(ns, bk):
    """Arithmetic with the first argument's error pushed to about 0.2·Q by
    adding p·K to c0 (the plaintext stays the same): strict ERW passes
    `add` (rate ≈ 0.2 < 0.25) and must raise at `mul`, where the product
    of the error terms wraps mod Q."""
    ctx, compiled, pts, args = _arith_setup(ns, bk, seed=SEED + 1)
    ct = args[0]
    Q = 1
    for q in ct.qs:
        Q *= q
    p = ct.zp
    big = (Q // 5) // p * p
    phi = ct.comps[0].data.shape[-1]
    lift = np.stack([np.full(phi, big % q, dtype=np.int64) for q in ct.qs])
    c0 = ct.comps[0] + ns["Cyc"].from_coeffs(ct.m_prime, ct.qs, lift, bk)
    noisy = ct.with_comps((c0, *ct.comps[1:]))
    lenient = ns["erw"].eval_with_error_rates(compiled.ir, ctx, noisy, args[1])[1]
    try:
        ns["erw"].eval_with_error_rates(compiled.ir, ctx, noisy, args[1], strict=True)
    except ns["erw"].NoiseOverflowError as e:
        return lenient, str(e)
    return lenient, None


@pytest.mark.parametrize("bk", ["torch-cpu", "golden"])
def test_strict_mode_raises_at_the_same_op(bk):
    want_log, want_err = _noisy_script(JAX, jgolden())
    got_log, got_err = _noisy_script(PORT, _bk(bk))
    assert got_log == want_log
    assert 0.2 < got_log[0][1] < 0.25 and got_log[1][1] > 0.25
    assert got_err == want_err and got_err.startswith("mul_Zq[268440577,8392193]: error rate")


def test_device_probe_matches_jax_and_host_probe():
    """`noise_probe.error_rate_device` on the port's torch backend equals the
    JAX package's device probe on its XLA backend and both host probes
    (test_noise_ledger.py:87-111)."""
    from alchemy_tpu.backend import xla_backend
    from alchemy_tpu.she.noise_probe import error_rate_device as jax_device_rate

    jctx, jc, _, jargs = _arith_setup(JAX, xla_backend(), seed=11)
    tctx, tc, _, targs = _arith_setup(PORT, TorchBackend(device="cpu"), seed=11)
    jout, tout = jeval_ir(jc.ir, *jargs), teval_ir(tc.ir, *targs)
    for jct, tct in zip((*jargs, jout), (*targs, tout)):
        jsk, tsk = jctx.lookup_key(jct.m_prime), tctx.lookup_key(tct.m_prime)
        rate = noise_probe.error_rate_device(tsk, tct)
        assert rate == tbgv.error_rate(tsk, tct) == jax_device_rate(jsk, jct) \
            == jbgv.error_rate(jsk, jct)


def _max_abs_big(res, qs):
    """max |centered CRT lift| of each column, in Python ints."""
    Q = 1
    for q in qs:
        Q *= q
    best = 0
    for col in np.asarray(res).T:
        v = 0
        for r, q in zip(col.tolist(), qs):
            Qi = Q // q
            v = (v + r * Qi * pow(Qi, -1, q)) % Q
        best = max(best, abs(v - Q if v > Q // 2 else v))
    return best


@pytest.mark.parametrize("nlimb", [1, 2, 3, 5])
def test_max_abs_digits_is_exact(nlimb):
    """The digit probe against Python big ints and the JAX package's
    `max_abs_digits`, on random residues and on the edge values 0, ±1,
    ⌊Q/2⌋ and Q − ⌊Q/2⌋."""
    from alchemy_tpu.she.noise_probe import max_abs_digits as jax_digits

    qs = (1543651201, 689270401, 718099201, 720720001, 1556755201)[:nlimb]
    Q = 1
    for q in qs:
        Q *= q
    rng = np.random.default_rng(nlimb)
    cols = [0, 1, Q - 1, Q // 2, Q - Q // 2] + [int(rng.integers(0, 1 << 62)) * (Q >> 62 or 1) % Q
                                                  for _ in range(40)]
    for pick in (cols, cols[:3], [cols[0]], [cols[4]]):
        res = np.array([[c % q for c in pick] for q in qs], dtype=np.int64)
        digits = noise_probe.max_abs_digits(torch.from_numpy(res), qs)
        pi = 1
        V = 0
        for d, q in zip(digits.tolist(), qs):
            V += d * pi
            pi *= q
        assert V == _max_abs_big(res, qs)
        assert digits.tolist() == np.asarray(jax_digits(res.astype(np.uint32), qs)).tolist()
        assert noise_probe.rate_from_digits(digits.tolist(), qs) == float(V / Q)


def test_resolve_log_reads_every_deferred_rate():
    """`resolve_log` resolves deferred digit vectors of different lengths
    (one copy for all of them) to the floats of the JAX package's
    `resolve_log`, keeps plain floats, and in strict mode raises on an
    over-threshold entry."""
    from alchemy_tpu.she.noise_probe import DeferredRate as JDeferred

    qs3, qs2 = (268440577, 8392193, 1073750017), (268440577, 8392193)
    d3, d2 = [12345, 6789, 3], [5, 1]
    log = [("a", noise_probe.DeferredRate(torch.tensor(d3), qs3)), ("b", 0.125),
           ("c", noise_probe.DeferredRate(torch.tensor(d2), qs2))]
    jlog = [("a", JDeferred(np.array(d3), qs3)), ("b", 0.125), ("c", JDeferred(np.array(d2), qs2))]
    got = terw.resolve_log(log)
    assert got == jerw.resolve_log(jlog)
    assert got[1] == ("b", 0.125) and all(isinstance(r, float) for _, r in got)
    bad = [("synthetic", noise_probe.DeferredRate(torch.tensor([q // 2 for q in qs3]), qs3))]
    assert terw.resolve_log(bad)[0][1] > terw.NOISE_OVERFLOW_THRESHOLD
    with pytest.raises(terw.NoiseOverflowError, match="synthetic: error rate"):
        terw.resolve_log(bad, strict=True)


def test_lenient_erw_on_torch_defers_the_probes():
    """On a torch backend the lenient probe leaves each digit vector on the
    device (a `DeferredRate` in the raw log) and strict mode resolves it at
    the op; both end in the same floats."""
    from alchemy_tpu_torch.interp.error_writer import write_error_rates

    ctx, compiled, _, args = _arith_setup(PORT, TorchBackend(device="cpu"))
    v, raw = teval_ir(write_error_rates(compiled.ir, ctx))
    for a in args:
        v, more = v(a)
        raw = raw + more
    assert raw and all(isinstance(r, noise_probe.DeferredRate) for _, r in raw)
    strict = terw.eval_with_error_rates(compiled.ir, ctx, *args, strict=True)[1]
    assert terw.resolve_log(raw) == strict
    assert all(isinstance(r, float) for _, r in strict)


def test_keys_hints_default_to_the_card():
    """`KeysHints(bk=None)` is on the card (`get_backend("torch")`); with no
    card it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert TKeysHints(3.0).bk.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TKeysHints(3.0)


@pytest.mark.cuda
def test_compile_and_evaluate_checked_on_the_card():
    """The same script on the checked backend (every torch op on the card
    held against golden numpy) against the JAX package."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from alchemy_tpu_torch.backend import get_backend

    want = arith_script(JAX, jgolden())
    got = arith_script(PORT, get_backend("checked"))
    assert got == want
