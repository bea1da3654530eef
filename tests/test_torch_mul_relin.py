"""alchemy_tpu_torch kernels A and B (backend/cuda/mul_relin.py): the plain
versions against the JAX package's mul_relin (exact equality), and the host
tables the CUDA kernels use against the 3-factor slot order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.backend.ntt3 import intt3, ntt3
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast


def _jax_state(log_n, L, Bt, shoup, seed):
    p = jfast.FastParams.make(log_n, L, impl="pallas")
    rng = np.random.default_rng(seed)
    s = jfast.keygen(p, rng)
    hb, ha = jfast.relin_hint(p, s, rng, shoup=shoup)
    cts = [jfast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng) for _ in range(2 * Bt)]
    return p, hb, ha, jnp.stack(cts[:Bt]), jnp.stack(cts[Bt:])


def _port_mul_relin(p, ct_a, ct_b, hb, ha):
    """Kernel A then kernel B through the wrappers (plain versions on CPU)."""
    c0, c1, c2c = mr.tensor_intt(p.n, p.qs, to_torch(ct_a), to_torch(ct_b))
    return mr.digit_relin(p.n, p.qs, c0, c1, c2c, to_torch(hb), to_torch(ha))


@pytest.mark.parametrize("log_n,L,Bt", [(10, 3, 1), (11, 5, 3)])
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_plain_kernels_match_jnp_mul_relin(log_n, L, Bt, shoup):
    p, hb, ha, ct_a, ct_b = _jax_state(log_n, L, Bt, shoup, seed=log_n + L)
    ref = jfast._mul_relin_jnp(p, ct_a, ct_b, hb, ha)
    out = _port_mul_relin(p, ct_a, ct_b, hb, ha)
    assert np.array_equal(to_numpy(out), np.asarray(ref))


def test_plain_kernels_match_pallas_kernels_interpret(monkeypatch):
    """The Pallas kernels A and B (ct-major) themselves, run in interpret
    mode as tests/test_pallas.py runs them."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.mul_relin_pallas as mrk
    import alchemy_tpu.backend.pallas.ntt_pallas as npk

    orig = pl.pallas_call

    def interpret(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(npk.pl, "pallas_call", interpret)
    monkeypatch.setattr(mrk.pl, "pallas_call", interpret)
    p, hb, ha, ct_a, ct_b = _jax_state(11, 5, 3, shoup=True, seed=3)
    ref = mrk.mul_relin_pallas(p, ct_a, ct_b, hb, ha)
    out = _port_mul_relin(p, ct_a, ct_b, hb, ha)
    assert np.array_equal(to_numpy(out), np.asarray(ref))


def _bitrev_forward(x, tw, q):
    """Radix-2 Cooley-Tukey forward NTT as the CUDA kernel runs it (zq.cuh
    ntt_forward), in numpy."""
    a = x.copy()
    n = len(a)
    t, m = n, 1
    k = np.arange(n // 2)
    while m < n:
        t //= 2
        i = k // t
        j = 2 * i * t + k % t
        u, v = a[j], a[j + t] * tw[m + i] % q
        a[j], a[j + t] = (u + v) % q, (u - v) % q
        m *= 2
    return a


def _bitrev_inverse(a, tw, q):
    """Gentleman-Sande inverse without the 1/n scale (zq.cuh ntt_inverse)."""
    a = a.copy()
    n = len(a)
    t, h = 1, n // 2
    k = np.arange(n // 2)
    while h >= 1:
        i = k // t
        j = 2 * i * t + k % t
        u, v = a[j], a[j + t]
        a[j], a[j + t] = (u + v) % q, (u - v) % q * tw[h + i] % q
        t *= 2
        h //= 2
    return a


def _check_slot_contract(log_n):
    p = jfast.FastParams.make(log_n, 2)
    t = mr.kernel_tables(p.n, p.qs)
    slot = t["slot_ct"]
    assert np.array_equal(np.sort(slot), np.arange(p.n))          # a permutation
    rng = np.random.default_rng(log_n)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs])
    y = ntt3(torch.from_numpy(x), p.n, p.qs).numpy()
    for li, q in enumerate(p.qs):
        fwd, inv = t["fwd"][li].astype(np.int64), t["inv"][li].astype(np.int64)
        # Shoup companions ⌊w·2^32/q⌋ of the twiddles
        assert np.array_equal(fwd[1], (fwd[0] << 32) // q)
        assert np.array_equal(inv[1], (inv[0] << 32) // q)
        # kernel B reads slot s from index slot_ct[s] of its forward NTT
        assert np.array_equal(_bitrev_forward(x[li], fwd[0], q)[slot], y[li])
        # kernel A scatters slot s to index slot_ct[s] before its inverse
        a = np.empty(p.n, dtype=np.int64)
        a[slot] = y[li]
        n_inv, n_inv_s = (int(v) for v in t["limbs"][li, 1:3])
        assert n_inv * p.n % q == 1 and n_inv_s == (n_inv << 32) // q
        assert np.array_equal(_bitrev_inverse(a, inv[0], q) * n_inv % q, x[li])
        lo, hi = (int(v) for v in t["limbs"][li, 4:6])
        assert t["limbs"][li, 0] == q and (hi << 32 | lo) == (1 << 64) // q
        assert t["limbs"][li, 3] == (1 << 32) // q
    assert np.array_equal(intt3(torch.from_numpy(y), p.n, p.qs).numpy(), x)


@pytest.mark.parametrize("log_n", [10, 11, 12])
def test_kernel_tables_map_radix2_order_to_slot_order(log_n):
    _check_slot_contract(log_n)


@pytest.mark.slow
@pytest.mark.parametrize("log_n", [14, 15])
def test_kernel_tables_map_radix2_order_to_slot_order_full_size(log_n):
    _check_slot_contract(log_n)


def test_wrappers_check_their_inputs():
    p = jfast.FastParams.make(10, 2)
    good = torch.zeros((1, 2, 2, p.n), dtype=torch.int32)
    with pytest.raises(ValueError):
        mr.tensor_intt(p.n, p.qs, good.to(torch.int64), good)
    with pytest.raises(ValueError):
        mr.tensor_intt(p.n, p.qs, good, good[:, :, :1].contiguous())
    c = torch.zeros((1, 2, p.n), dtype=torch.int32)
    h = torch.zeros((2, 2, p.n), dtype=torch.int32)
    with pytest.raises(ValueError):
        mr.digit_relin(p.n, p.qs, c, c, c, (h, h), (h, h[:1]))
    # what the CUDA path refuses, checked without a card
    with pytest.raises(NotImplementedError):
        mr._kernel_device(1 << 16, torch.device("cuda"))
    with pytest.raises(ValueError):
        mr._kernel_device(1 << 15, torch.device("meta"))
    mr._kernel_device(1 << 15, torch.device("cuda"))


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt", [(14, 3, 2), (15, 8, 2)])
def test_kernels_match_plain_on_the_card(log_n, L, Bt):
    _need_card()
    p = tfast.FastParams.make(log_n, L)
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    res = lambda shape: to_torch(rng.integers(0, 1 << 62, shape) % q, "cuda")
    ct_a, ct_b = res((Bt, 2, L, p.n)), res((Bt, 2, L, p.n))
    hb, ha = (tfast.shoup_precompute(res((L, L, p.n)), p.qs) for _ in range(2))
    before = dict(mr.LAUNCHES)
    c = mr.tensor_intt(p.n, p.qs, ct_a, ct_b)
    assert all(torch.equal(x, y) for x, y in zip(c, mr.tensor_intt_plain(p.n, p.qs, ct_a, ct_b)))
    out = mr.digit_relin(p.n, p.qs, *c, hb, ha)
    assert torch.equal(out, mr.digit_relin_plain(p.n, p.qs, *c, hb, ha))
    # raw hints: the Barrett branch of kernel B, the same residues
    assert torch.equal(mr.digit_relin(p.n, p.qs, *c, hb[0], ha[0]), out)
    assert mr.LAUNCHES == {**before, "tensor_intt": before["tensor_intt"] + 1,
                           "digit_relin": before["digit_relin"] + 2}


@pytest.mark.cuda
def test_mul_relin_on_the_card_matches_jax():
    _need_card()
    p, hb, ha, ct_a, ct_b = _jax_state(14, 3, 2, shoup=True, seed=14)
    ref = jfast._mul_relin_jnp(p, ct_a, ct_b, hb, ha)
    tp = tfast.FastParams(n=p.n, qs=p.qs, zp=p.zp)
    out = tfast.mul_relin(tp, to_torch(ct_a, "cuda"), to_torch(ct_b, "cuda"),
                          to_torch(tuple(map(np.asarray, hb)), "cuda"),
                          to_torch(tuple(map(np.asarray, ha)), "cuda"))
    assert out.is_cuda and np.array_equal(to_numpy(out), np.asarray(ref))
