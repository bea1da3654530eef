"""alchemy_tpu_torch.backend.ntt2 (the 2-factor slot order of
`FastParams(impl="mxu")`) and kernels 8 and 9 (backend/cuda/rescale.py
`ntt2_grid`, `intt2_grid`): the plain transforms against the JAX package's
`ntt_mxu`, `intt_mxu`, `ntt_mxu_bcast` and its Pallas kernels `ntt_pallas`,
`intt_pallas` in interpret mode, and the kernels' 2-factor slot table against
a numpy emulation of their split radix-2 schedule (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.backend import ntt_mxu as jmxu
from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch.backend import ntt2
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.backend.cuda import rescale as rk
from alchemy_tpu_torch.convert import to_numpy, to_torch
from test_torch_mul_relin import _bitrev_forward, _bitrev_inverse, _split_forward, _split_inverse


def _u32(rng, shape, hi=1 << 32):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _same(jax_out, torch_out):
    return np.array_equal(np.asarray(jax_out).astype(np.int64), torch_out.numpy())


def test_pick_split_matches_jax():
    for log_n in range(5, 17):
        assert ntt2._pick_split(1 << log_n) == jmxu._pick_split(1 << log_n)
    assert [ntt2._pick_split(1 << k) for k in (5, 14, 15, 16)] == [
        (32, 1), (128, 128), (128, 256), (256, 256)]
    with pytest.raises(ValueError):
        ntt2._pick_split(1 << 17)


def _check_ntt2(log_n, nlimb):
    p = jfast.FastParams.make(log_n, nlimb, impl="mxu")
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, (2, p.n)) for q in p.qs], axis=1).astype(np.uint32)
    t = torch.from_numpy(x.astype(np.int64))
    y = ntt2.ntt2(t, p.n, p.qs)                        # leading batch dim
    assert _same(jmxu.ntt_mxu(jnp.asarray(x), p.n, p.qs), y)
    assert _same(jmxu.intt_mxu(jnp.asarray(y.numpy().astype(np.uint32)), p.n, p.qs),
                 ntt2.intt2(y, p.n, p.qs))
    assert torch.equal(ntt2.intt2(y, p.n, p.qs), t)
    rows = _u32(rng, (2, 3, p.n))                      # unreduced digit rows
    assert _same(jmxu.ntt_mxu_bcast(jnp.asarray(rows), p.n, p.qs),
                 ntt2.ntt2_bcast(torch.from_numpy(rows.astype(np.int64)), p.n, p.qs))


@pytest.mark.parametrize("log_n", [10, 11, 12])
def test_ntt2_matches_ntt_mxu(log_n):
    _check_ntt2(log_n, 3)


def test_ntt2_matches_ntt_mxu_with_one_column():
    """n = 2^5, the deep-circuit test's ring: n2 = 1."""
    _check_ntt2(5, 4)


@pytest.mark.slow
@pytest.mark.parametrize("log_n", [14, 15, 16])
def test_ntt2_matches_ntt_mxu_full_size(log_n):
    _check_ntt2(log_n, 2)


def test_plain_kernels_8_and_9_match_pallas_kernels_interpret(monkeypatch):
    """`ntt_pallas` and `intt_pallas` (kernels 8 and 9 of the TPU) run in
    interpret mode with the monkeypatch of tests/test_pallas.py; the port's
    wrappers (plain versions on the CPU) give the same residues, on one row
    group [1, L, n] as the TPU kernels take it and on several."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.ntt_pallas as npk

    orig = pl.pallas_call
    monkeypatch.setattr(npk.pl, "pallas_call", lambda *a, **k: orig(*a, **{"interpret": True, **k}))
    p = jfast.FastParams.make(10, 3, impl="mxu")
    rng = np.random.default_rng(8)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    y = npk.ntt_pallas(jnp.asarray(x), p.n, p.qs)
    got = rk.ntt2_grid(p.n, p.qs, to_torch(x[None], "cpu"))
    assert got.shape == (1, 3, p.n) and np.array_equal(to_numpy(got)[0], np.asarray(y))
    back = rk.intt2_grid(p.n, p.qs, got)
    assert np.array_equal(to_numpy(back)[0], np.asarray(npk.intt_pallas(y, p.n, p.qs)))
    assert np.array_equal(to_numpy(back)[0], x)
    # [G, L, n] with any uint32 in: the kernels reduce first, as ntt2/intt2 do
    u = _u32(rng, (2, 3, p.n))
    q = np.array(p.qs, dtype=np.uint64)[:, None]
    for fn, plain in ((rk.ntt2_grid, ntt2.ntt2), (rk.intt2_grid, ntt2.intt2)):
        want = plain(torch.from_numpy((u % q).astype(np.int64)), p.n, p.qs)
        assert np.array_equal(to_numpy(fn(p.n, p.qs, to_torch(u, "cpu"))).astype(np.int64),
                              want.numpy())


@pytest.mark.parametrize("log_n", [10, 11, 12, 16])
def test_mxu_slot_table_matches_split_schedule(log_n):
    """The 2-factor slot table (`slot_tables(n, "mxu")`: slot k1·n2 + k2 holds
    x(ψ^{2K+1}), K = k1 + n1·k2, at radix-2 index bitrev(K)) through the
    kernels' index logic: the whole radix-2 NTT gathered by slot_ct, and the
    split schedule of two blocks per limb (slot_inv ownership, fused first
    forward stage, cross-half last inverse stage), against ntt2/intt2."""
    p = jfast.FastParams.make(log_n, 2, impl="mxu")
    t = mr.kernel_tables(p.n, p.qs, "mxu")
    slot = t["slot_ct"]
    assert np.array_equal(np.sort(slot), np.arange(p.n))          # a permutation
    assert np.array_equal(t["slot_inv"][slot], np.arange(p.n))    # and its inverse
    assert not np.array_equal(slot, mr.kernel_tables(p.n, p.qs)["slot_ct"])
    rng = np.random.default_rng(log_n)
    x = _u32(rng, (2, p.n)).astype(np.int64)                      # any uint32
    q = np.array(p.qs, dtype=np.int64)[:, None]
    y = ntt2.ntt2(torch.from_numpy(x), p.n, p.qs).numpy()
    for li, ql in enumerate(p.qs):
        fwd, inv = t["fwd"][li, 0].astype(np.int64), t["inv"][li, 0].astype(np.int64)
        n_inv = int(t["limbs"][li, 1])
        assert np.array_equal(_bitrev_forward(x[li] % ql, fwd, ql)[slot], y[li])
        a = np.empty(p.n, dtype=np.int64)
        a[slot] = y[li]
        assert np.array_equal(_bitrev_inverse(a, inv, ql) * n_inv % ql, x[li] % ql)
        assert np.array_equal(_split_forward(x[li], fwd, ql, t["slot_inv"]), y[li])
        assert np.array_equal(_split_inverse(y[li], inv, ql, t["slot_inv"], n_inv), x[li] % ql)
    assert np.array_equal(ntt2.intt2(torch.from_numpy(y), p.n, p.qs).numpy(), x % q)


def test_kernels_8_and_9_stay_off_the_card_and_check_inputs(monkeypatch):
    from alchemy_tpu_torch.backend.cuda import build

    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    p = jfast.FastParams.make(10, 3, impl="mxu")
    x = torch.zeros((2, 3, p.n), dtype=torch.int32)
    assert rk.ntt2_grid(p.n, p.qs, x).shape == rk.intt2_grid(p.n, p.qs, x).shape == x.shape
    for bad in (x.long(), x[:, :2], x[0]):
        with pytest.raises(ValueError):
            rk.ntt2_grid(p.n, p.qs, bad)
        with pytest.raises(ValueError):
            rk.intt2_grid(p.n, p.qs, bad)
    assert rk.grid_transforms("mxu") == (rk.ntt2_grid, rk.intt2_grid)
    assert rk.grid_transforms("pallas", plain=True) == (rk.ntt3_grid_plain, rk.intt3_grid_plain)
    with pytest.raises(ValueError):
        rk.grid_transforms("radix4")


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,G", [(14, 5, 3), (15, 8, 32), (16, 3, 2)])
def test_kernels_8_and_9_match_plain_on_the_card(log_n, L, G):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = jfast.FastParams.make(log_n, L, impl="mxu")
    x = to_torch(_u32(np.random.default_rng(log_n), (G, L, p.n)), "cuda")
    before = dict(rk.LAUNCHES)
    assert torch.equal(rk.ntt2_grid(p.n, p.qs, x), rk.ntt2_grid_plain(p.n, p.qs, x))
    assert torch.equal(rk.intt2_grid(p.n, p.qs, x), rk.intt2_grid_plain(p.n, p.qs, x))
    assert rk.LAUNCHES == {**before, "ntt2_grid": before["ntt2_grid"] + 1,
                           "intt2_grid": before["intt2_grid"] + 1}
