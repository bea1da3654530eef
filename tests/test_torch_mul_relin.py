"""alchemy_tpu_torch kernels A and B (backend/cuda/mul_relin.py): the plain
versions against the JAX package's mul_relin (exact equality), the host
tables the CUDA kernels use against the 3-factor slot order, and the index
schedule of the kernels (each limb split over two blocks) emulated in numpy."""

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
    c0, c1, c2c = mr.tensor_intt(p.n, p.qs, to_torch(ct_a, "cpu"), to_torch(ct_b, "cpu"))
    return mr.digit_relin(p.n, p.qs, c0, c1, c2c, to_torch(hb, "cpu"), to_torch(ha, "cpu"))


@pytest.mark.parametrize("log_n,L,Bt", [(10, 3, 1), (11, 5, 3)])
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_plain_kernels_match_jnp_mul_relin(log_n, L, Bt, shoup):
    p, hb, ha, ct_a, ct_b = _jax_state(log_n, L, Bt, shoup, seed=log_n + L)
    ref = jfast._mul_relin_jnp(p, ct_a, ct_b, hb, ha)
    out = _port_mul_relin(p, ct_a, ct_b, hb, ha)
    assert np.array_equal(to_numpy(out), np.asarray(ref))


def _interpret(monkeypatch):
    """Run the Pallas kernels of mul_relin in interpret mode, as
    tests/test_pallas.py runs them; returns mul_relin_pallas's module."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.mul_relin_pallas as mrk
    import alchemy_tpu.backend.pallas.ntt_pallas as npk

    orig = pl.pallas_call

    def interpret(*a, **k):
        k.setdefault("interpret", True)
        return orig(*a, **k)

    monkeypatch.setattr(npk.pl, "pallas_call", interpret)
    monkeypatch.setattr(mrk.pl, "pallas_call", interpret)
    return mrk


def test_plain_kernels_match_pallas_kernels_interpret(monkeypatch):
    """The Pallas kernels A and B (ct-major) themselves, run in interpret
    mode as tests/test_pallas.py runs them."""
    mrk = _interpret(monkeypatch)
    p, hb, ha, ct_a, ct_b = _jax_state(11, 5, 3, shoup=True, seed=3)
    ref = mrk.mul_relin_pallas(p, ct_a, ct_b, hb, ha)
    out = _port_mul_relin(p, ct_a, ct_b, hb, ha)
    assert np.array_equal(to_numpy(out), np.asarray(ref))


def test_plain_kernels_match_pallas_kernels_3_interpret_at_2e16(monkeypatch):
    """n = 2^16 with raw hints: the JAX package takes kernel A and the
    limb-major kernel 3 (mul_relin_pallas.py:319), run in interpret mode;
    the port's kernels A and B (plain versions here) give the same residues."""
    mrk = _interpret(monkeypatch)
    p, hb, ha, ct_a, ct_b = _jax_state(16, 2, 1, shoup=False, seed=16)
    ref = mrk.mul_relin_pallas(p, ct_a, ct_b, hb, ha)
    out = _port_mul_relin(p, ct_a, ct_b, hb, ha)
    assert np.array_equal(to_numpy(out), np.asarray(ref))


def _bitrev_forward(x, tw, q, split=0, part=0):
    """Radix-2 Cooley-Tukey forward NTT as the CUDA kernel runs it (zq.cuh
    ntt_forward), in numpy. split = 1: x is half `part` of a limb of
    2·len(x) words, and only the stages inside that half run, with the
    whole transform's twiddles m + part·m/2 + i."""
    a = x.copy()
    log_n = (len(a) << split).bit_length() - 1
    k = np.arange(len(a) // 2)
    m, log_t = 1 << split, log_n - split - 1
    while log_t >= 0:
        t = 1 << log_t
        i = k >> log_t
        j = (i << (log_t + 1)) + (k & (t - 1))
        u, v = a[j], a[j + t] * tw[m + part * (m >> split) + i] % q
        a[j], a[j + t] = (u + v) % q, (u - v) % q
        m, log_t = m << 1, log_t - 1
    return a


def _bitrev_inverse(a, tw, q, split=0, part=0):
    """Gentleman-Sande inverse without the 1/n scale (zq.cuh ntt_inverse);
    split = 1 runs the stages inside half `part` only, as _bitrev_forward."""
    a = a.copy()
    log_n = (len(a) << split).bit_length() - 1
    k = np.arange(len(a) // 2)
    h, log_t = 1 << (log_n - 1), 0
    while log_t < log_n - split:
        t = 1 << log_t
        i = k >> log_t
        j = (i << (log_t + 1)) + (k & (t - 1))
        u, v = a[j], a[j + t]
        a[j], a[j + t] = (u + v) % q, (u - v) % q * tw[h + part * (h >> split) + i] % q
        h, log_t = h >> 1, log_t + 1
    return a


def _split_forward(x, tw, q, slot_inv):
    """Kernels B and 6 as they run (rescale.cu ntt_grid_kernel): block
    `part` fuses the first stage into its load (zq.cuh forward_first_stage,
    any uint32 x), runs the stages inside its half and writes slot
    slot_inv[part·n/2 + j] from its word j → the row in slot order."""
    half = len(x) // 2
    u, v = x[:half] % q, x[half:] * tw[1] % q
    out = np.empty(len(x), dtype=np.int64)
    for part, first in enumerate(((u + v) % q, (u - v) % q)):
        out[slot_inv[part * half:(part + 1) * half]] = _bitrev_forward(first, tw, q, 1, part)
    return out


def _split_inverse(y, tw, q, slot_inv, n_inv):
    """Kernels A and 5 as they run (rescale.cu intt_grid_kernel): block
    `part` gathers the slots slot_inv[part·n/2 + j], runs the stages inside
    its half, and the cluster's last stage (zq.cuh inverse_last_stage) pairs
    the halves and scales by n⁻¹ → natural-order coefficients."""
    half = len(y) // 2
    u, v = (_bitrev_inverse(y[slot_inv[p * half:(p + 1) * half]], tw, q, 1, p) for p in (0, 1))
    return np.concatenate([(u + v) % q * n_inv % q, (u - v) % q * tw[1] % q * n_inv % q])


def _check_slot_contract(log_n):
    p = jfast.FastParams.make(log_n, 2)
    t = mr.kernel_tables(p.n, p.qs)
    slot = t["slot_ct"]
    assert np.array_equal(np.sort(slot), np.arange(p.n))          # a permutation
    assert np.array_equal(t["slot_inv"][slot], np.arange(p.n))    # and its inverse
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


@pytest.mark.parametrize("log_n", [14, 15, 16])
def test_kernel_tables_map_radix2_order_to_slot_order_full_size(log_n):
    """2^16 is the only size with the radix-4 factor (r = 4) of the slot
    order."""
    _check_slot_contract(log_n)


@pytest.mark.parametrize("log_n", [10, 11, 12, 16])
def test_split_schedule_matches_ntt3(log_n):
    """The index logic of kernels A, B, 5 and 6 (two blocks per limb, the
    slot_inv ownership, the fused first forward stage and the cross-half
    last inverse stage) against ntt3/intt3 (exact), at 2^16 (the radix-4
    slot order) and at small sizes."""
    p = jfast.FastParams.make(log_n, 2)
    t = mr.kernel_tables(p.n, p.qs)
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, 1 << 32, (2, p.n), dtype=np.uint64).astype(np.int64)  # any uint32
    q = np.array(p.qs, dtype=np.int64)[:, None]
    y = ntt3(torch.from_numpy(x), p.n, p.qs).numpy()
    assert np.array_equal(intt3(torch.from_numpy(y), p.n, p.qs).numpy(), x % q)
    for li, ql in enumerate(p.qs):
        fwd, inv = t["fwd"][li, 0].astype(np.int64), t["inv"][li, 0].astype(np.int64)
        assert np.array_equal(_split_forward(x[li], fwd, ql, t["slot_inv"]), y[li])
        n_inv = int(t["limbs"][li, 1])
        assert np.array_equal(_split_inverse(y[li], inv, ql, t["slot_inv"], n_inv), x[li] % ql)


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
    # the sizes the CUDA path takes, and what it refuses, checked without a card
    cuda = torch.device("cuda")
    for log_n in (10, 15, 16):
        mr._kernel_device(1 << log_n, cuda)
    mr._kernel_device(1 << 15, cuda, split=False)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        mr._kernel_device(1 << 16, cuda, split=False)
    for split in (True, False):
        with pytest.raises(NotImplementedError):
            mr._kernel_device(1 << 17, cuda, split=split)
    with pytest.raises(ValueError):
        mr._kernel_device(1 << 15, torch.device("meta"))


class _Gate(Exception):
    """Raised in place of a launch once the gate passed: carries whether
    the wrapper asked for half a limb per block."""


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_wrapper_gates_by_ring_size(monkeypatch, log_n):
    """Each wrapper's gate, reached with tensors on the meta device (no
    memory, no card) and the gate asked as for CUDA: kernels A, B, 5 and 6
    (half a limb per block) take 2^16; 4 and 7 refuse it; all refuse 2^17."""
    from alchemy_tpu_torch.backend.cuda import rescale as rk

    real = mr._kernel_device

    def gate(n, device, split=True):
        assert device.type == "meta"
        real(n, torch.device("cuda"), split)
        raise _Gate(split)

    monkeypatch.setattr(mr, "_kernel_device", gate)
    monkeypatch.setattr(rk, "_kernel_device", gate)
    n, qs = 1 << log_n, (12289, 40961, 65537)[:2]
    z = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    c, h, x = z(1, 2, n), z(2, 2, n), z(1, 2, n)
    calls = {
        "A": lambda: mr.tensor_intt(n, qs, z(1, 2, 2, n), z(1, 2, 2, n)),
        "B": lambda: mr.digit_relin(n, qs, c, c, c, h, h),
        "B_shoup": lambda: mr.digit_relin(n, qs, c, c, c, (h, h), (h, h)),
        "5": lambda: rk.intt3_grid(n, qs, x),
        "6": lambda: rk.ntt3_grid(n, qs, x),
        "4": lambda: mr.hybrid_digit_stage(n, qs + (7681,), ((qs[0],), (qs[1],)), x,
                                           z(2, 3, n), z(2, 3, n)),
        "7": lambda: rk.rescale_fwd(n, qs[:1], qs[1:], 2, x, z(1, 1, n), z(1, n), z(1, n),
                                    z(1, n)),
    }
    for name, call in calls.items():
        if log_n == 17 or (log_n == 16 and name in ("4", "7")):
            with pytest.raises(NotImplementedError):
                call()
        else:
            with pytest.raises(_Gate) as got:
                call()
            assert got.value.args[0] == (name not in ("4", "7")), name


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt", [(14, 3, 2), (15, 8, 2), (16, 3, 2)])
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
@pytest.mark.parametrize("log_n", [14, 16])
def test_mul_relin_on_the_card_matches_jax(log_n):
    """At 2^16 each limb of kernels A and B needs two blocks."""
    _need_card()
    p, hb, ha, ct_a, ct_b = _jax_state(log_n, 3, 2, shoup=True, seed=log_n)
    ref = jfast._mul_relin_jnp(p, ct_a, ct_b, hb, ha)
    tp = tfast.FastParams(n=p.n, qs=p.qs, zp=p.zp)
    out = tfast.mul_relin(tp, to_torch(ct_a, "cuda"), to_torch(ct_b, "cuda"),
                          to_torch(tuple(map(np.asarray, hb)), "cuda"),
                          to_torch(tuple(map(np.asarray, ha)), "cuda"))
    assert out.is_cuda and np.array_equal(to_numpy(out), np.asarray(ref))
