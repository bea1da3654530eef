"""The JAX package's other NTT implementations in the port: impl="vpu" (the
radix-2 order of `alchemy_tpu/backend/ntt.py`, port `backend/ntt.py` and the
kernels' "vpu" tables) and impl="mxu8" (the 2-factor order, run as "mxu").
Keys, hints, ciphertexts, `mul_relin`, `rescale` and `mul_relin_hybrid`
equal the JAX package's bit for bit from one seed (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.she import fast as jfast
from alchemy_tpu.she import hybrid as jhyb
from alchemy_tpu_torch.backend import ntt as tntt
from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.backend.cuda import rescale as rk
from alchemy_tpu_torch.backend.modarith import narrow, widen
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast
from alchemy_tpu_torch.she import hybrid as thyb
from alchemy_tpu_torch.utils import profiling


def _eq(jax_arr, port):
    return np.array_equal(np.asarray(jax_arr), to_numpy(port))


def _flat(h):
    return [*h[0], *h[1]] if isinstance(h[0], (tuple, list)) else list(h)


def _negacyclic_mod2(m1, m2):
    n = len(m1)
    c = np.convolve(m1.astype(np.int64), m2.astype(np.int64))
    return (c[:n] + np.concatenate([c[n:], [0]])) % 2


@pytest.mark.parametrize("log_n", [3, 5, 10])
def test_ntt_vpu_matches_ntt_negacyclic(log_n):
    """Forward and inverse against the JAX pair on canonical rows with a
    leading batch axis; any uint32 goes in as its residue (the kernels'
    contract); the broadcast form is the transform of the reduced rows."""
    p = jfast.FastParams.make(log_n, 3, impl="vpu")
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, (2, p.n)) for q in p.qs], axis=1).astype(np.uint32)
    y = tntt.ntt_vpu(torch.from_numpy(x.astype(np.int64)), p.n, p.qs)
    assert np.array_equal(np.asarray(ntt_negacyclic(jnp.asarray(x), p.n, p.qs)), y.numpy())
    back = tntt.intt_vpu(y, p.n, p.qs)
    assert np.array_equal(back.numpy(), x.astype(np.int64))
    assert np.array_equal(np.asarray(intt_negacyclic(jnp.asarray(y.numpy().astype(np.uint32)),
                                                     p.n, p.qs)), back.numpy())
    u = rng.integers(0, 1 << 32, (2, 3, p.n), dtype=np.uint64).astype(np.int64)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    assert torch.equal(tntt.ntt_vpu(torch.from_numpy(u), p.n, p.qs),
                       tntt.ntt_vpu(torch.from_numpy(u % q), p.n, p.qs))
    assert torch.equal(tntt.intt_vpu(torch.from_numpy(u), p.n, p.qs),
                       tntt.intt_vpu(torch.from_numpy(u % q), p.n, p.qs))
    rows = torch.from_numpy(u[:, :2])                                  # [2, D=2, n]
    want = torch.stack([tntt.ntt_vpu(rows[:, d, None, :] % torch.from_numpy(q), p.n, p.qs)
                        for d in range(2)], dim=1)
    assert torch.equal(tntt.ntt_vpu_bcast(rows, p.n, p.qs), want)


@pytest.mark.parametrize("log_n", [10, 12, 14, 16])
def test_vpu_slot_table_is_the_identity(log_n):
    """The kernels' radix-2 NTT already leaves the vpu order (slot s holds
    x(ψ^{2·bitrev(s)+1}) at index s): slot_ct and slot_inv are the identity,
    and each part of a limb owns its own contiguous run of slots."""
    n = 1 << log_n
    slot_ct, slot_inv = launch.slot_tables(n, "vpu")
    assert np.array_equal(slot_ct, np.arange(n)) and np.array_equal(slot_inv, np.arange(n))
    t = launch.kernel_tables(n, tfast.FastParams.make(log_n, 1).qs, "vpu")
    for parts, key in ((2, "slot_own"), (4, "slot_own4")):
        own = t[key].astype(np.int64)
        local = np.tile(np.arange(n // parts), parts)
        assert np.array_equal(own & 0xFFFF, np.arange(n)) and np.array_equal(own >> 16, local)


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
@pytest.mark.parametrize("impl", ["vpu", "mxu8"])
def test_slice_matches_jax(impl, shoup):
    """keygen, relin_hint, encrypt, mul_relin (kernels A and B, plain
    versions here), rescale and decrypt at impl from one seed, against the
    JAX package at the same impl."""
    jp = jfast.FastParams.make(10, 3, impl=impl)
    tp = tfast.FastParams.make(10, 3, impl=impl)
    assert tp.impl == impl and tp.order == ("mxu" if impl == "mxu8" else impl)
    rj, rt = np.random.default_rng(60), np.random.default_rng(60)
    sj, st = jfast.keygen(jp, rj), tfast.keygen(tp, rt, device="cpu")
    assert _eq(sj, st)
    hj = jfast.relin_hint(jp, sj, rj, shoup=shoup)
    ht = tfast.relin_hint(tp, st, rt, shoup=shoup)
    assert all(_eq(a, b) for a, b in zip(_flat(hj), _flat(ht)))
    msgs = rj.integers(0, 2, (4, jp.n))
    rt.integers(0, 2, (4, jp.n))
    cj = jnp.stack([jfast.encrypt(jp, sj, m, rj) for m in msgs])
    ct = torch.stack([tfast.encrypt(tp, st, m, rt) for m in msgs])
    assert _eq(cj, ct)
    ref = jfast.mul_relin(jp, cj[:2], cj[2:], *hj)
    out = tfast.mul_relin(tp, ct[:2], ct[2:], *ht)
    assert _eq(ref, out)
    assert _eq(jfast.rescale(jp, ref, 2), tfast.rescale(tp, out, 2))
    for i in range(2):
        assert np.array_equal(tfast.decrypt(tp, st, out[i]),
                              _negacyclic_mod2(msgs[i], msgs[2 + i]))


def test_mxu8_runs_the_mxu_order():
    """"mxu8" shares every residue with "mxu" in the port, as the JAX
    package's int8 planes do in its own."""
    x = np.random.default_rng(8).integers(0, 1 << 20, (2, 3, 1 << 10)).astype(np.uint32)
    jp, tp = (jfast.FastParams.make(10, 3, impl="mxu8"), tfast.FastParams.make(10, 3, impl="mxu8"))
    assert _eq(jfast._ntt_p(jp, jnp.asarray(x)), tfast._ntt_p(tp, to_torch(x, "cpu")))
    assert torch.equal(tfast._ntt_p(tp, to_torch(x, "cpu")),
                       tfast._ntt_p(tfast.FastParams.make(10, 3, impl="mxu"), to_torch(x, "cpu")))


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_hybrid_matches_jax_vpu(shoup):
    """impl="vpu" in kernels A, 4, 5 and 7 (plain versions here) against the
    JAX package's hybrid path; uneven digit groups 3 + 2; rescale_joint
    against fast.rescale at k_drop = 1."""
    jp = jfast.FastParams.make(10, 5, zp=2, impl="vpu", bits=24)
    tp = tfast.FastParams.make(10, 5, zp=2, bits=24, impl="vpu")
    jhk, thk = jhyb.HybridKS.make(jp, bits=24), thyb.HybridKS.make(tp, bits=24)
    rj, rt = np.random.default_rng(61), np.random.default_rng(61)
    sj, hj = jhyb.hybrid_keygen_hint(jhk, rj)
    st, ht = thyb.hybrid_keygen_hint(thk, rt, device="cpu")
    assert thk.pe.impl == "vpu" and _eq(sj, st) and _eq(hj[0], ht[0]) and _eq(hj[1], ht[1])
    msgs = rj.integers(0, 2, (2, 2, 1 << 10))
    cts = jnp.stack([jnp.stack([jfast.encrypt(jhk.p, sj, m, rj) for m in row]) for row in msgs])
    ref = jhyb.mul_relin_hybrid(jhk, cts[0], cts[1], *hj)
    if shoup:
        ht = tuple(tfast.shoup_precompute(h, thk.pe.qs) for h in ht)
    a, b = to_torch(cts[0], "cpu"), to_torch(cts[1], "cpu")
    out = thyb.mul_relin_hybrid(thk, a, b, *ht)
    assert _eq(ref, out) and torch.equal(out, thyb.mul_relin_hybrid_plain(thk, a, b, *ht))
    for i in range(2):
        assert np.array_equal(tfast.decrypt(thk.p, st, out[i]),
                              _negacyclic_mod2(msgs[0, i], msgs[1, i]))
    assert torch.equal(thyb.rescale_joint(thk.p, out, 1), tfast.rescale(thk.p, out, 1))


def test_vpu_grid_wrappers_stay_off_the_card(monkeypatch):
    from alchemy_tpu_torch.backend.cuda import build

    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    p = tfast.FastParams.make(10, 3, impl="vpu")
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 1 << 30, (2, 3, p.n))
                         .astype(np.int32))
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms("vpu"), rk.grid_transforms("vpu", True)
    profiling.reset()
    with profiling.tracing():
        y = fwd(p.n, p.qs, x)
        assert torch.equal(inv(p.n, p.qs, y), inv_plain(p.n, p.qs, y))
    assert [s.name for s in profiling.spans()] == ["launch.ntt_vpu_grid", "launch.intt_vpu_grid"]
    profiling.reset()
    assert torch.equal(y, fwd_plain(p.n, p.qs, x))
    assert torch.equal(y, narrow(tntt.ntt_vpu(widen(x), p.n, p.qs)))
    with pytest.raises(ValueError):
        fwd(p.n, p.qs, x[:, :2])


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt", [(14, 4, 2), (15, 8, 2), (16, 3, 2)])
def test_vpu_kernels_match_plain_on_the_card(log_n, L, Bt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = tfast.FastParams.make(log_n, L, impl="vpu")
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    rand = lambda *shape: torch.from_numpy((rng.integers(0, 1 << 62, shape) % q)
                                           .astype(np.int32)).cuda()
    a, b = rand(Bt, 2, L, p.n), rand(Bt, 2, L, p.n)
    ka = mr.tensor_intt(p.n, p.qs, a, b, "vpu")
    for x, y in zip(ka, mr.tensor_intt_plain(p.n, p.qs, a, b, "vpu")):
        assert torch.equal(x, y)
    hb, ha = rand(L, L, p.n), rand(L, L, p.n)
    assert torch.equal(mr.digit_relin(p.n, p.qs, *ka, hb, ha, "vpu"),
                       mr.digit_relin_plain(p.n, p.qs, *ka, hb, ha, "vpu"))
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms("vpu"), rk.grid_transforms("vpu", True)
    x = rand(2 * Bt, L, p.n)
    assert torch.equal(fwd(p.n, p.qs, x), fwd_plain(p.n, p.qs, x))
    assert torch.equal(inv(p.n, p.qs, x), inv_plain(p.n, p.qs, x))
