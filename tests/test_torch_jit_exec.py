"""alchemy_tpu_torch.interp.jit_exec: a compiled program prepared once and
called many times. On `TorchBackend("cpu")` the prepared program runs
eagerly; it must equal the JAX package's `jit_compile` (one XLA executable
on the CPU) from the same seed, ciphertext and error-rate log, and the port's
own eager evaluation. On the card the program is a CUDA graph (one `cuda`
test). Also: strict overflow raises before a ciphertext is returned, the
argument metadata is checked, outputs of two calls do not alias, and a
prepared run copies nothing between host and device."""

import numpy as np
import pytest
import torch

import alchemy_tpu.examples.arithmetic as jarith
from alchemy_tpu.backend import xla_backend
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.interp import jit_exec as jjit
from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
from alchemy_tpu.she.gadget import TrivGad as JTrivGad
import alchemy_tpu_torch.examples.arithmetic as tarith
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.examples import common, tunnel
from alchemy_tpu_torch.interp.error_writer import NoiseOverflowError, eval_with_error_rates
from alchemy_tpu_torch.interp.eval import eval_ir
from alchemy_tpu_torch.interp.jit_exec import jit_compile
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.noise import PtTy
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.gadget import BaseBGad, TrivGad
from alchemy_tpu_torch.she.keys import uniform_residues

SEED = 0


def _arith(ns, Cyc_, KeysHints_, pt2ct_, TrivGad_, bk):
    """Arithmetic's addMul compiled, keyed and encrypted at SEED on bk."""
    rng = np.random.default_rng(SEED)
    pts = [Cyc_.from_coeffs(ns.M, (ns.ZP,), rng.integers(0, ns.ZP, totient(ns.M)), bk)
           for _ in range(2)]
    ctx = KeysHints_(3.0, seed=SEED, bk=bk)
    compiled = pt2ct_(ns.addMul, res_ty=ns.PT, m_map=ns.M_MAP, zqs=ns.ZQS, gad=TrivGad_(),
                      ctx=ctx)
    return ctx, compiled, pts, [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]


@pytest.fixture(scope="module")
def port():
    bk = TorchBackend(device="cpu")
    return (bk, *_arith(tarith, Cyc, KeysHints, pt2ct, TrivGad, bk))


@pytest.fixture(scope="module")
def jax_side():
    return _arith(jarith, JCyc, JKeysHints, jpt2ct, JTrivGad, xla_backend())


@pytest.fixture(autouse=True)
def _no_aot_cache(monkeypatch):
    # the JAX package's jit_compile would otherwise write its artifacts to /tmp
    monkeypatch.setenv("ALCHEMY_AOT_CACHE", "0")


def _res(ct):
    return [np.asarray(c.bk.to_numpy(c.to_pow().data)) for c in ct.comps]


def _equal(a, b):
    return (a.m, a.zp, a.scale, a.qs) == (b.m, b.zp, b.scale, b.qs) and all(
        np.array_equal(x, y) for x, y in zip(_res(a), _res(b)))


def test_jit_matches_the_jax_jit_compile(port, jax_side):
    bk, ctx, compiled, pts, args = port
    jctx, jcompiled, jpts, jargs = jax_side
    assert all(np.array_equal(x, y) for a, ja in zip(args, jargs)
               for x, y in zip(_res(a), _res(ja)))
    ref = jjit.jit_compile(jcompiled, jargs)(*jargs)
    out = jit_compile(compiled, args)(*args)
    assert _equal(out, ref) and _equal(out, eval_ir(compiled.ir, *args))
    want = eval_ir(tarith.addMul, *pts)
    dec = compiled.decrypt(out)
    assert dec.equals(want)
    assert np.array_equal(bk.to_numpy(dec.data), np.asarray(jcompiled.decrypt(ref).data))


def test_jit_noise_probe_log_matches_jax_and_eager(port, jax_side):
    bk, ctx, compiled, pts, args = port
    jctx, jcompiled, jpts, jargs = jax_side
    jout, jlog = jjit.jit_compile(jcompiled, jargs, noise_probe=jctx, strict=True)(*jargs)
    for strict in (False, True):
        out, log = jit_compile(compiled, args, noise_probe=ctx, strict=strict)(*args)
        eager, elog = eval_with_error_rates(compiled.ir, ctx, *args, strict=strict)
        assert log == elog == jlog and len(log) == 5
        assert _equal(out, eager) and _equal(out, jout)


def test_jit_strict_overflow_raises_before_returning(port):
    """c0 replaced by uniform residues: the first probe overflows, and the
    call raises instead of returning the ciphertext (a lenient call logs
    the same rates and returns it)."""
    bk, ctx, compiled, pts, args = port
    c0 = args[0].comps[0]
    rng = np.random.default_rng(1)
    bad0 = Cyc.from_coeffs(c0.m, c0.qs, uniform_residues(rng, c0.qs, c0.ring.phi), bk)
    bad = CT(m=args[0].m, zp=args[0].zp, scale=args[0].scale,
             comps=(bad0.to_basis(c0.basis), *args[0].comps[1:]))
    strict = jit_compile(compiled, args, noise_probe=ctx, strict=True)
    with pytest.raises(NoiseOverflowError, match="exceeds"):
        strict(bad, args[1])
    out, log = jit_compile(compiled, args, noise_probe=ctx)(bad, args[1])
    assert isinstance(out, CT) and max(rate for _, rate in log) > 0.25
    with pytest.raises(NoiseOverflowError):
        eval_with_error_rates(compiled.ir, ctx, bad, args[1], strict=True)


def test_jit_tunnel_program_matches_eager():
    """`switch(2)` (two ring tunnels with BaseBGad 2, the Tunnel example's
    rings and moduli) through the prepared program equals eager evaluation
    and decrypts to the plaintext."""
    bk = TorchBackend(device="cpu")
    rng = np.random.default_rng(1)
    expr = common.switch(2, tunnel.ZP, bk)
    x = Cyc.from_coeffs(common.H0, (tunnel.ZP,), rng.integers(0, tunnel.ZP, totient(common.H0)), bk)
    ctx = KeysHints(3.0, seed=1, bk=bk)
    compiled = pt2ct(expr, res_ty=PtTy(pnoise=0, m=common.TOWER[2], zp=tunnel.ZP),
                     m_map=common.M_MAP, zqs=tunnel.ZQS, gad=BaseBGad(2), ctx=ctx)
    ct = compiled.encrypt_arg(x, 0)
    out = jit_compile(compiled, [ct])(ct)
    assert _equal(out, eval_ir(compiled.ir, ct))
    assert compiled.decrypt(out).equals(eval_ir(expr, x))


def test_jit_prepared_run_copies_nothing(port):
    """After the first call (which fills the upload caches, as the warm-up
    does on the card), a call moves nothing between host and device."""
    bk, ctx, compiled, pts, args = port
    j = jit_compile(compiled, args, noise_probe=ctx)
    j(*args)
    before = dict(bk.counts)
    j(*args)
    assert {k: bk.counts[k] - before.get(k, 0) for k in ("to_host", "to_device", "mat_upload")} \
        == {"to_host": 0, "to_device": 0, "mat_upload": 0}


def test_jit_checks_argument_metadata(port):
    bk, ctx, compiled, pts, args = port
    j = jit_compile(compiled, args)
    a = args[0]
    for bad in (a.with_comps(a.comps, scale=a.scale + 1),
                a.with_comps(tuple(c.to_basis("CRT" if c.basis == "POW" else "POW")
                                   for c in a.comps))):
        with pytest.raises(ValueError, match="metadata"):
            j(bad, args[1])
    with pytest.raises(ValueError):
        j(args[0])
    with pytest.raises(ValueError, match="TorchBackend"):
        from alchemy_tpu_torch.backend import golden_backend

        jit_compile(compiled, [CT(m=a.m, zp=a.zp, scale=a.scale, comps=tuple(
            Cyc(c.ring, c.qs, c.basis, bk.to_numpy(c.data), golden_backend()) for c in a.comps))])


def test_jit_outputs_do_not_alias(port):
    """Two calls on different inputs: the first output keeps its values."""
    bk, ctx, compiled, pts, args = port
    j = jit_compile(compiled, args)
    first = j(*args)
    kept = _res(first)
    other = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(reversed(pts))]
    second = j(*other)
    assert all(np.array_equal(x, y) for x, y in zip(_res(first), kept))
    assert not all(np.array_equal(x, y) for x, y in zip(_res(first), _res(second)))
    assert compiled.decrypt(second).equals(eval_ir(tarith.addMul, *reversed(pts)))


@pytest.mark.cuda
def test_jit_graph_replay_matches_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    bk = TorchBackend(device="cuda")
    ctx, compiled, pts, args = _arith(tarith, Cyc, KeysHints, pt2ct, TrivGad, bk)
    j = jit_compile(compiled, args, noise_probe=ctx, strict=True)
    assert j.graph is not None
    eager, elog = eval_with_error_rates(compiled.ir, ctx, *args, strict=True)
    before = {k: bk.counts[k] for k in ("to_host", "to_device", "mat_upload")}
    outs = [j(*args) for _ in range(2)]
    assert before == {k: bk.counts[k] for k in before}
    for out, log in outs:
        assert out.comps[0].data.is_cuda and _equal(out, eager) and log == elog
    assert compiled.decrypt(outs[0][0]).equals(eval_ir(tarith.addMul, *pts))
