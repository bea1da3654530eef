"""alchemy_tpu_torch kernels A and B (backend/cuda/mul_relin.py): the plain
versions against the JAX package's mul_relin (exact equality), the host
tables the CUDA kernels use against the 3-factor slot order, and the index
schedules of the kernels (each limb split over two blocks or four; the
register-blocked passes of A, B, 4, 5, 6, 7, 8 and 9) emulated in numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.backend.cuda import rescale as rk
from alchemy_tpu_torch.backend.modarith import narrow, widen
from alchemy_tpu_torch.backend.ntt2 import _pick_split
from alchemy_tpu_torch.backend.ntt3 import _split3, intt3, ntt3
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast
from alchemy_tpu_torch.she import hybrid as thyb
from alchemy_tpu_torch.utils import profiling


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
    """The forward NTT split over two blocks: block `part` fuses the first
    stage into its load (any uint32 x), runs the stages inside its half and
    writes slot slot_inv[part·n/2 + j] from its word j → the row in slot
    order."""
    half = len(x) // 2
    u, v = x[:half] % q, x[half:] * tw[1] % q
    out = np.empty(len(x), dtype=np.int64)
    for part, first in enumerate(((u + v) % q, (u - v) % q)):
        out[slot_inv[part * half:(part + 1) * half]] = _bitrev_forward(first, tw, q, 1, part)
    return out


def _split_inverse(y, tw, q, slot_inv, n_inv):
    """The inverse NTT split over two blocks: block `part` gathers the slots
    slot_inv[part·n/2 + j], runs the stages inside its half, and the
    cluster's last stage pairs the halves and scales by n⁻¹ →
    natural-order coefficients."""
    half = len(y) // 2
    u, v = (_bitrev_inverse(y[slot_inv[p * half:(p + 1) * half]], tw, q, 1, p) for p in (0, 1))
    return np.concatenate([(u + v) % q * n_inv % q, (u - v) % q * tw[1] % q * n_inv % q])


def _check_slot_contract(log_n):
    p = jfast.FastParams.make(log_n, 2)
    t = launch.kernel_tables(p.n, p.qs)
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
    """The mathematics of a limb split over two blocks (the slot_inv
    ownership, the fused first forward stage and the cross-half last
    inverse stage) against ntt3/intt3 (exact), at 2^16 (the radix-4 slot
    order) and at small sizes."""
    p = jfast.FastParams.make(log_n, 2)
    t = launch.kernel_tables(p.n, p.qs)
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


#: launch shapes of kernels B and 4 (mul_relin.cu Shape, BSmall ... ExtLarge):
#: (threads a block, stages a pass at most, stages of the first pass,
#: whether the first pass reads the two halves of a cluster, log2 of the
#: blocks of a limb, lazy butterflies); "B" is BLarge (halves, n = 2^16),
#: "B lazy" BSmall (halves, n <= 2^15), "B quarters" BQuarter (quarters,
#: 2^10 <= n <= 2^15)
RB_SHAPES = {"B": (1024, 3, 3, False, 1, False), "B lazy": (1024, 3, 3, False, 1, True),
             "B quarters": (512, 3, 3, False, 2, True),
             "4 n<=2^15": (384, 3, 2, True, 1, False), "4 n=2^16": (1024, 4, 3, False, 1, False)}


def _pad(j):
    """zq.cuh pad: one spare shared word after every 32."""
    return j + (j >> 5)


def _rb_butterflies(v, log_n, part, lo_b, hi, tw, q, split=1, tws=None):
    """zq.cuh pass_butterflies on v [R, groups], a group a column (hi its
    high index bits): stage u pairs r with r + R/2^(u+1) under twiddle
    m + part·m/2^split + (hi << u) + (r >> (RL − u)). With the twiddles'
    Shoup companions tws, the lazy butterflies (kLazy) in uint32 arithmetic:
    words in [0, 4q), x − 2q where x ≥ 2q, y·w by the Shoup quotient
    without its last correction, x + y and x − y + 2q."""
    RL = len(v).bit_length() - 1
    for u in range(RL):
        m = 1 << (log_n - lo_b - RL + u)
        w0 = m + part * (m >> split) + (hi << u)
        t = len(v) >> (u + 1)
        for blk in range(1 << u):
            w = tw[w0 + blk]
            for c in range(t):
                r = 2 * t * blk + c
                if tws is None:
                    a, b = v[r], v[r + t] * w % q
                    v[r], v[r + t] = (a + b) % q, (a - b) % q
                    continue
                a = np.where(v[r] >= 2 * q, v[r] - 2 * q, v[r])
                y = v[r + t].astype(np.uint64)
                quot = (y * tws[w0 + blk].astype(np.uint64)) >> np.uint64(32)
                b = ((y * np.uint64(w) - quot * np.uint64(q)) & np.uint64(_M32)).astype(np.int64)
                assert (b < 2 * q).all()
                v[r], v[r + t] = a + b, a - b + 2 * q
                assert (v[r] < 4 * q).all() and (v[r + t] > 0).all() and (v[r + t] < 4 * q).all()
    return v


def _rb_forward(x, tw, q, part, max_rl, first_rl, pair, split=1, tws=None):
    """zq.cuh ntt_forward_passes (or ntt_forward_pair) of half `part` of row
    x (any uint32) in numpy → the padded shared half. The first pass takes
    words j and j + n/2 of each group from x (pair: from the two blocks'
    staged halves, x_j and w·x_{j+n/2}) and runs the cross-half stage on them,
    then first_rl stages; later passes take max_rl stages from shared memory.
    The groups of every pass cover the half once, group g on thread
    g mod blockDim. split = 2: quarter `part` of the row, the first pass
    taking words j + c·n/4 (c < 4) and running the two cross-quarter stages
    on them (zq.cuh quarter_load). tws: the lazy butterflies of
    _rb_butterflies, the half's words in [0, 4q)."""
    half = len(x) >> split
    log_n, log_h = len(x).bit_length() - 1, half.bit_length() - 1
    smem = np.full(_pad(half - 1) + 1, -1, dtype=np.int64)
    lo_b = max(log_h - first_rl, 0)
    first = True
    while first or lo_b > 0:
        RL = log_h - lo_b if first else min(max_rl, lo_b)
        lo_b -= 0 if first else RL
        g = np.arange(half >> RL)
        hi = g >> lo_b
        j = ((hi << (lo_b + RL)) | (g & ((1 << lo_b) - 1))) + (np.arange(1 << RL)[:, None] << lo_b)
        assert np.array_equal(np.sort(j.ravel()), np.arange(half))
        if first and split == 2:
            w1, w2 = tw[1], tw[2 + (part >> 1)]
            x0, x1 = x[j] % q, x[j + half] % q
            y2, y3 = x[j + 2 * half] * w1 % q, x[j + 3 * half] * w1 % q
            a, b = ((x0 - y2) % q, (x1 - y3) % q) if part >> 1 else ((x0 + y2) % q, (x1 + y3) % q)
            c = b * w2 % q
            v = (a - c) % q if part & 1 else (a + c) % q
        elif first and pair:
            staged = [x[:half] % q, x[half:] * tw[1] % q]        # each block's own half
            mine, other = staged[part][j], staged[1 - part][j]
            v = (other - mine) % q if part else (mine + other) % q
        elif first:
            u, v = x[j] % q, x[j + half] * tw[1] % q
            v = (u - v) % q if part else (u + v) % q
        else:
            v = smem[_pad(j)]
        smem[_pad(j)] = _rb_butterflies(v, log_n, part, lo_b, hi, tw, q, split, tws)
        first = False
    return smem


@pytest.mark.parametrize("shape", sorted(RB_SHAPES))
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n", [10, 11, 12, 16])
def test_register_blocked_schedule_matches_plain_ntt(log_n, order, shape):
    """The schedule of kernels B and 4 at each launch shape (register-blocked
    passes, the stages that cross the parts in the first pass's load or
    across the cluster, the hint loop's slot-order gather through `slot_own`,
    or `slot_own4` for B's quarters) against ntt3 ("pallas"), ntt2 ("mxu")
    and ntt_vpu ("vpu") exactly, at 2^16 and at small sizes. Every slot has
    one owner thread, the same at every digit; a thread's four elements are
    four consecutive slots from a multiple of 4, and the 128 elements of a
    warp consecutive slots (from n = 2^14 on; runs of a row of the slot
    order below). Lazy shapes leave words in [0, 4q), right mod q, which the
    hint products take as they are."""
    threads, max_rl, first_rl, pair, split, lazy = RB_SHAPES[shape]
    parts = 1 << split
    p = jfast.FastParams.make(log_n, 2)
    n, half = p.n, p.n >> split
    t = launch.kernel_tables(n, p.qs, order)
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.int64)  # any uint32
    y = launch.plain_transforms(order)[0](torch.from_numpy(x), n, p.qs).numpy()
    own = t["slot_own" if split == 1 else "slot_own4"].astype(np.int64).reshape(parts, half)
    slots, local = own & 0xFFFF, own >> 16
    assert np.array_equal(np.sort(slots.ravel()), np.arange(n))
    A, B, r = _split3(n)
    run = _pick_split(n)[1] if order == "mxu" else B * r    # a row of the slot order
    for part in range(parts):
        assert np.array_equal(np.sort(slots[part]), np.sort(t["slot_inv"][part * half:(part + 1) * half]))
        assert np.array_equal(local[part], t["slot_ct"][slots[part]] - part * half)
        for width in (min(4, run), min(128, run)):       # a thread's quad; a warp's 128
            lanes = slots[part].reshape(-1, width)
            assert np.array_equal(lanes - lanes[:, :1], np.broadcast_to(np.arange(width), lanes.shape))
            assert (lanes[:, 0] % width == 0).all()
    owners = []
    for li, ql in enumerate(p.qs):                     # the two limbs stand for two digits
        fwd = t["fwd"][li, 0].astype(np.int64)
        tws = t["fwd"][li, 1].astype(np.int64) if lazy else None
        got = np.full(n, -1, dtype=np.int64)
        owner = np.full(n, -1, dtype=np.int64)
        for part in range(parts):
            smem = _rb_forward(x[li], fwd, ql, part, max_rl, first_rl, pair, split, tws)
            assert (got[slots[part]] == -1).all()
            got[slots[part]] = smem[_pad(local[part])]
            owner[slots[part]] = part * threads + np.arange(half) // 4 % threads
        assert (got >= 0).all() and (got < (4 if lazy else 1) * ql).all()
        assert np.array_equal(got % ql, y[li])
        owners.append(owner)
    assert (owners[0] >= 0).all() and np.array_equal(owners[0], owners[1])


#: launch shapes of kernels 5, 6, 8 and 9 (rescale.cu GridShape: GridOne,
#: GridTwo, GridFour, and GridOne with a limb over four blocks at 2^16):
#: (threads a block, stages a pass at most, log2 of the blocks of a limb)
GRID_SHAPES = {"one": (1024, 4, 1), "two": (512, 4, 1), "four": (1024, 3, 2),
               "four 2^16": (1024, 4, 2)}


def _rb_inverse(y, tw, q, part, max_rl, own, split=1):
    """Kernel 5's half `part` as it runs (rescale.cu intt_grid_kernel) on row
    y (slot order, any uint32), in numpy → the padded shared half before the
    cluster's last stage: the slot-order gather through slot_own (reduced,
    placed at pad of its radix-2 index), then zq.cuh ntt_inverse_passes:
    passes of up to max_rl stages from the smallest stride up; stage u of a
    pass pairs r with r + 2^u under twiddle h + part·h/2 + (hi << (RL−1−u))
    + (r >> (u + 1)), h = 2^(log_n − 1 − lo_b − u). split = 2: quarter
    `part` (slot_own4), twiddles h + part·h/4 + ...."""
    half = len(y) >> split
    log_n, log_h = len(y).bit_length() - 1, half.bit_length() - 1
    smem = np.full(_pad(half - 1) + 1, -1, dtype=np.int64)
    slots, local = own & 0xFFFF, own >> 16
    smem[_pad(local)] = y[slots] % q
    assert (smem[_pad(np.arange(half))] >= 0).all()
    lo_b = 0
    while lo_b < log_h:
        RL = min(max_rl, log_h - lo_b)
        g = np.arange(half >> RL)
        hi = g >> lo_b
        j = ((hi << (lo_b + RL)) | (g & ((1 << lo_b) - 1))) + (np.arange(1 << RL)[:, None] << lo_b)
        assert np.array_equal(np.sort(j.ravel()), np.arange(half))
        v = smem[_pad(j)]
        for u in range(RL):
            h = 1 << (log_n - 1 - lo_b - u)
            w0 = h + part * (h >> split) + (hi << (RL - 1 - u))
            s = 1 << u
            for r in range(1 << RL):
                if r & s:
                    continue
                w = tw[w0 + (r >> (u + 1))]
                a, b = v[r].copy(), v[r + s].copy()
                v[r], v[r + s] = (a + b) % q, (a - b) % q * w % q
        smem[_pad(j)] = v
        lo_b += RL
    return smem


def _last_stages(a, inv, q, n_inv):
    """The stages of the inverse NTT that cross the parts, scaled by n⁻¹, on
    the parts a (each in natural order within the part): zq.cuh
    inverse_last_stage for two, inverse_last_stages4 for four."""
    if len(a) == 2:
        got = np.concatenate([(a[0] + a[1]) % q, (a[0] - a[1]) % q * inv[1] % q])
    else:
        b0, b2 = (a[0] + a[1]) % q, (a[2] + a[3]) % q
        b1, b3 = (a[0] - a[1]) % q * inv[2] % q, (a[2] - a[3]) % q * inv[3] % q
        got = np.concatenate([(b0 + b2) % q, (b1 + b3) % q,
                              (b0 - b2) % q * inv[1] % q, (b1 - b3) % q * inv[1] % q])
    return got * n_inv % q


@pytest.mark.parametrize("direction", ["forward", "inverse"])
@pytest.mark.parametrize("shape", sorted(GRID_SHAPES))
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n", [10, 11, 12, 16])
def test_grid_kernel_schedule_matches_plain_ntt(log_n, order, shape, direction):
    """The schedule of kernels 6/8 (forward: register-blocked passes from the
    row, the stages that cross the parts in the first pass's load, then each
    block's slots stored in slot order, four consecutive slots a thread) and
    5/9 (inverse: the slot-order gather, the inverse passes, the cluster's
    last stages scaled by n⁻¹) at each launch shape, a limb over two blocks
    or four, against ntt3/intt3 ("pallas"), ntt2/intt2 ("mxu") and
    ntt_vpu/intt_vpu ("vpu") exactly.
    Every slot is written or read once, in quads of four consecutive slots
    from a multiple of 4."""
    _, max_rl, split = GRID_SHAPES[shape]
    parts = 1 << split
    p = jfast.FastParams.make(log_n, 2)
    n, size = p.n, p.n >> split
    t = launch.kernel_tables(n, p.qs, order)
    fwd_plain, inv_plain = launch.plain_transforms(order)[:2]
    rng = np.random.default_rng(log_n)
    x = rng.integers(0, 1 << 32, (2, n), dtype=np.uint64).astype(np.int64)  # any uint32
    q = np.array(p.qs, dtype=np.int64)[:, None]
    plain = fwd_plain if direction == "forward" else inv_plain
    want = plain(torch.from_numpy(x % q), n, p.qs).numpy()
    own = t["slot_own" if split == 1 else "slot_own4"].astype(np.int64).reshape(parts, size)
    slots, local = own & 0xFFFF, own >> 16
    assert np.array_equal(np.sort(slots.ravel()), np.arange(n))
    for part in range(parts):               # the quads of each thread, as walk_slots takes them
        assert np.array_equal(local[part], t["slot_ct"][slots[part]] - part * size)
        quads = slots[part].reshape(-1, 4)
        assert np.array_equal(quads - quads[:, :1], np.broadcast_to(np.arange(4), quads.shape))
        assert (quads[:, 0] % 4 == 0).all()
    for li, ql in enumerate(p.qs):
        if direction == "forward":
            fwd = t["fwd"][li, 0].astype(np.int64)
            got = np.full(n, -1, dtype=np.int64)
            for part in range(parts):
                smem = _rb_forward(x[li], fwd, ql, part, max_rl, max_rl, False, split)
                assert (got[slots[part]] == -1).all()
                got[slots[part]] = smem[_pad(local[part])]
        else:
            inv = t["inv"][li, 0].astype(np.int64)
            n_inv = int(t["limbs"][li, 1])
            a = [_rb_inverse(x[li], inv, ql, part, max_rl, own[part], split)[_pad(np.arange(size))]
                 for part in range(parts)]
            got = _last_stages(a, inv, ql, n_inv)
        assert np.array_equal(got, want[li])


@pytest.mark.parametrize("shape", sorted(GRID_SHAPES))
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n", [10, 11, 12, 16])
def test_kernel_a_schedule_matches_plain(log_n, order, shape):
    """Kernel A as it runs (mul_relin.cu tensor_intt_kernel, launched by
    zq.cuh launch_grid in the launch shapes of 5 and 9) at each launch shape,
    a limb over two blocks or four: each block walks its slots in slot order
    (slot_own or slot_own4), computes the Karatsuba product of each slot,
    writes c0 and c1 there and places c2 at its radix-2 index in the part;
    then the inverse passes and the cluster's last stages → (c0, c1, c2c)
    against `tensor_intt_plain` exactly, in each order. Every slot of c0 and
    c1 is written once."""
    _, max_rl, split = GRID_SHAPES[shape]
    parts = 1 << split
    p = jfast.FastParams.make(log_n, 2)
    n, size = p.n, p.n >> split
    t = launch.kernel_tables(n, p.qs, order)
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    ct_a, ct_b = (rng.integers(0, 1 << 62, (1, 2, 2, n)) % q for _ in range(2))
    want = [w.numpy() for w in mr.tensor_intt_plain(n, p.qs, torch.from_numpy(ct_a),
                                                    torch.from_numpy(ct_b), order)]
    own = t["slot_own" if split == 1 else "slot_own4"].astype(np.int64).reshape(parts, size)
    slots = own & 0xFFFF
    for li, ql in enumerate(p.qs):
        (a0, a1), (b0, b1) = ct_a[0, :, li], ct_b[0, :, li]
        inv = t["inv"][li, 0].astype(np.int64)
        c0, c1 = np.full(n, -1, dtype=np.int64), np.full(n, -1, dtype=np.int64)
        halves = []
        for part in range(parts):
            s = slots[part]
            p0, p2 = a0[s] * b0[s] % ql, a1[s] * b1[s] % ql
            cross = (a0[s] + a1[s]) % ql * ((b0[s] + b1[s]) % ql) % ql
            assert (c0[s] == -1).all()
            c0[s], c1[s] = p0, (cross - p0 - p2) % ql
            c2 = np.full(n, -1, dtype=np.int64)          # only this block's slots
            c2[s] = p2
            halves.append(_rb_inverse(c2, inv, ql, part, max_rl, own[part], split)[_pad(np.arange(size))])
        got = _last_stages(halves, inv, ql, int(t["limbs"][li, 1]))
        for g, w in zip((c0, c1, got), want):
            assert np.array_equal(g, w[0, li])


_M32 = (1 << 32) - 1


def _shoup(a, w, ws, q):
    """zq.cuh mulmod_shoup on uint32 values in int64 arrays (a·w and the
    quotient estimate wrap at 32 bits as on the card)."""
    a = np.asarray(a, dtype=np.int64)
    hi = (a * int(ws)) >> 32
    r = (a * int(w) - hi * int(q)) & _M32
    return np.where(r >= q, r - q, r)


def _garner_emulated(r, rows, count):
    """zq.cuh garner: the digits of residues r [count, ...] (int64) from the
    host's Garner rows, as the card computes them."""
    w0 = 4 + mr.GARNER_MAX_DIGITS
    x = [np.asarray(r[0], dtype=np.int64)]
    for k in range(1, count):
        g = int(rows[k][0])
        acc = np.zeros_like(x[0])
        for j in range(k):
            acc = (acc + _shoup(x[j], rows[k][4 + j], rows[k][w0 + j], g)) % g
        x.append(_shoup((r[k] - acc) % g, rows[k][1], rows[k][2], g))
    return x


@pytest.mark.parametrize("L,dnum", [(5, 2), (7, 2), (16, 4), (18, 5)])
def test_garner_pack_arithmetic_matches_plain(L, dnum):
    """mul_relin.cu garner_pack_kernel as it computes (each group's rows of
    `garner_rows`'s table on the device, zq::garner in uint32 arithmetic) against
    `garner_pack_plain`, at uneven groups (3 + 2, 4 + 3, 4 × 4 + 2) and
    with every residue q − 1 and zeros."""
    p = tfast.FastParams.make(10, L, bits=30)
    groups = thyb.HybridKS.make(p, dnum=dnum).groups
    n, rng = p.n, np.random.default_rng(L)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    c2c = rng.integers(0, 1 << 62, (2, L, n)) % q
    c2c[:, :, 0], c2c[:, :, 1] = q[:, 0] - 1, 0
    table = launch.uploaded(mr.garner_rows, groups, device="cpu").numpy().view(np.uint32)
    table = table.astype(np.int64)
    alpha, got = len(groups[0]), np.empty_like(c2c)
    for gi, grp in enumerate(groups):
        k0 = gi * alpha
        got[:, k0:k0 + len(grp)] = np.stack(
            _garner_emulated(c2c[:, k0:k0 + len(grp)].transpose(1, 0, 2), table[k0:], len(grp)),
            axis=1)
    assert np.array_equal(got, widen(mr.garner_pack_plain(n, groups, torch.from_numpy(c2c))))


#: stages a pass of kernel 7 at most, the first pass's too (rescale.cu
#: RescaleSmall at n ≤ 2^15 and RescaleLarge at 2^16 differ only in threads,
#: which the schedule does not depend on)
RESCALE_MAX_RL = 3


def _drop_consts_fields(drop, zp):
    """rescale.cu DropConsts from the words `rk.drop_consts` hands the
    kernel: (Garner rows, digits of P//2, [π_k]_zp, zp, P mod zp, P⁻¹ mod zp)."""
    words = rk.drop_consts(drop, zp).astype(np.int64)
    m = mr.GARNER_MAX_DIGITS
    rows = words[:m * mr.GARNER_WORDS].reshape(m, mr.GARNER_WORDS)
    rest = words[m * mr.GARNER_WORDS:]
    assert len(rest) == 2 * m + 3
    return rows, rest[:m], rest[m:2 * m], *rest[2 * m:]


@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n,k_drop,zp", [(10, 3, 4), (11, 1, 2), (12, 4, 1 << 16),
                                             (16, 3, 2)])
def test_kernel_7_schedule_matches_plain(log_n, k_drop, zp, order):
    """Kernel 7 as it runs (rescale.cu rescale_fwd_kernel): the prologue as
    the kernel's `correction` computes it (zq::garner on the dropped rows'
    coefficients from `drop_consts`, V > P//2 by digits in ascending k, V
    mod zp and t, the base extension in ascending k, the sign corrections,
    (q_j − δ)·P⁻¹) as the load of the register-blocked forward passes, each
    block of the cluster pair evaluating it on its own half, then each
    block's slots stored in slot order with the kept row's slot (any
    uint32, NTT domain) times P⁻¹ and c0 or c1 added → against
    `rescale_fwd_plain` with c01 exactly, in each order, where V takes P//2,
    P//2 ± 1, 0 and P − 1. Every slot is written once."""
    import math

    p = jfast.FastParams.make(log_n, 2 + k_drop)
    n, half = p.n, p.n // 2
    keep, drop = p.qs[:2], p.qs[2:]
    P = math.prod(drop)
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    ntt = rng.integers(0, 1 << 32, (2, 2 + k_drop, n))                 # any uint32
    dropped = rng.integers(0, 1 << 62, (2, k_drop, n)) % q[2:]
    for i, v in enumerate((P // 2, P // 2 + 1, P // 2 - 1, 0, P - 1)):
        dropped[:, :, i] = np.array([v % g for g in drop])[None]
    c01 = rng.integers(0, 1 << 62, (2, 1, 2, n)) % q[:2]
    want = widen(rk.rescale_fwd_plain(n, keep, drop, zp, narrow(torch.from_numpy(ntt)),
                                      narrow(torch.from_numpy(dropped)), order,
                                      tuple(map(torch.from_numpy, c01))))
    t = launch.kernel_tables(n, keep, order)
    own = t["slot_own"].astype(np.int64).reshape(2, half)
    slots, local = own & 0xFFFF, own >> 16
    consts = rk.rescale_consts(keep, drop).astype(np.int64)
    rows, half_digits, pi_zp, dzp, p_zp, p_inv_zp = _drop_consts_fields(drop, zp)
    mask = dzp - 1
    for g in range(2):
        x = _garner_emulated(dropped[g], rows, k_drop)
        neg = np.zeros(n, dtype=bool)
        vz = np.zeros(n, dtype=np.int64)
        for k in range(k_drop):
            neg = np.where(x[k] != half_digits[k], x[k] > half_digits[k], neg)
            vz = (vz + (x[k] & mask) * pi_zp[k]) & _M32 & mask
        vz = np.where(neg, (vz + dzp - p_zp) & mask, vz)
        tz = ((dzp - vz) & mask) * p_inv_zp & _M32 & mask
        for j, qj in enumerate(keep):
            c = consts[j]
            v = np.zeros(n, dtype=np.int64)
            for k in range(k_drop):
                v = (v + _shoup(x[k], c[4 + k], c[4 + k_drop + k], qj)) % qj
            v = np.where(neg, (v - c[0]) % qj, v)
            tc = np.where(tz > dzp >> 1, qj - (dzp - tz), tz)
            delta = (v + _shoup(tc, c[0], c[1], qj)) % qj
            row = _shoup((0 - delta) % qj, c[2], c[3], qj)
            fwd = t["fwd"][j, 0].astype(np.int64)
            got = np.full(n, -1, dtype=np.int64)
            for part in (0, 1):
                smem = _rb_forward(row, fwd, qj, part, RESCALE_MAX_RL, RESCALE_MAX_RL, True)
                s = slots[part]
                assert (got[s] == -1).all()
                kept = _shoup(ntt[g, j, s], c[2], c[3], qj)
                got[s] = ((smem[_pad(local[part])] + kept) % qj + c01[g, 0, j, s]) % qj
            assert np.array_equal(got, want[0, g, j].numpy())


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
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    for log_n in (10, 15, 16):
        assert launch.on_card(1 << log_n, cuda) and not launch.on_card(1 << log_n, cpu)
    with pytest.raises(NotImplementedError, match="n ≤ 2\\^16"):
        launch.on_card(1 << 17, cuda)
    with pytest.raises(ValueError):
        launch.on_card(1 << 15, torch.device("meta"))
    with pytest.raises(ValueError, match="slot order"):
        mr.tensor_intt(p.n, p.qs, good, good, order="radix4")
    # kernels B and 4 read rows 16 bytes at a time: a view off a 16-byte boundary is refused
    row = torch.zeros(8, dtype=torch.int32)
    launch.aligned(row, None)
    with pytest.raises(ValueError, match="16-byte"):
        launch.aligned(row[1:])


class _Gate(Exception):
    """Raised in place of a launch once the gate passed: carries the ring
    size the wrapper asked for."""


@pytest.mark.parametrize("log_n", [15, 16, 17])
def test_wrapper_gates_by_ring_size(monkeypatch, log_n):
    """Each wrapper's gate, reached with tensors on the meta device (no
    memory, no card) and the gate asked as for CUDA: every kernel (A, B,
    4–9, both slot orders; half a limb per block) takes 2^15 and 2^16 and
    refuses 2^17."""
    real = launch.on_card

    def gate(n, device):
        assert device.type == "meta"
        real(n, torch.device("cuda"))
        raise _Gate(n)

    monkeypatch.setattr(launch, "on_card", gate)
    n, qs = 1 << log_n, (12289, 40961, 65537)[:2]
    z = lambda *shape: torch.empty(shape, dtype=torch.int32, device="meta")
    c, h, x = z(1, 2, n), z(2, 2, n), z(1, 2, n)
    calls = {
        "A": lambda: mr.tensor_intt(n, qs, z(1, 2, 2, n), z(1, 2, 2, n)),
        "A_mxu": lambda: mr.tensor_intt(n, qs, z(1, 2, 2, n), z(1, 2, 2, n), order="mxu"),
        "B": lambda: mr.digit_relin(n, qs, c, c, c, h, h),
        "B_shoup": lambda: mr.digit_relin(n, qs, c, c, c, (h, h), (h, h)),
        "B_tenants": lambda: mr.digit_relin(n, qs, c, c, c, (z(3, 2, 2, n),) * 2,
                                            (z(3, 2, 2, n),) * 2, tenant=z(1)),
        "5": lambda: rk.grid_transforms("pallas")[1](n, qs, x),
        "6": lambda: rk.grid_transforms("pallas")[0](n, qs, x),
        "8": lambda: rk.grid_transforms("mxu")[0](n, qs, x),
        "9": lambda: rk.grid_transforms("mxu")[1](n, qs, x),
        "9_window": lambda: rk.grid_transforms("mxu")[1](n, qs[1:], x),
        "5_vpu": lambda: rk.grid_transforms("vpu")[1](n, qs, x),
        "6_vpu": lambda: rk.grid_transforms("vpu")[0](n, qs, x),
        "4": lambda: mr.hybrid_digit_stage(n, qs + (7681,), ((qs[0],), (qs[1],)), x,
                                           z(2, 3, n), z(2, 3, n)),
        "7": lambda: rk.rescale_fwd(n, qs[:1], qs[1:], 2, x, z(1, 1, n)),
        "7_add_back": lambda: rk.rescale_fwd(n, qs[:1], qs[1:], 2, z(2, 2, n), z(2, 1, n), "mxu",
                                             (z(1, 1, n), z(1, 1, n))),
        "garner_pack": lambda: mr.garner_pack(n, ((qs[0],), (qs[1],)), x),
    }
    for name, call in calls.items():
        if log_n == 17:
            with pytest.raises(NotImplementedError):
                call()
        else:
            with pytest.raises(_Gate) as got:
                call()
            assert got.value.args[0] == n, name


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n,L,Bt", [(8, 2, 2), (14, 3, 2), (15, 8, 2), (16, 3, 2),
                                        (15, 8, 16), (15, 8, 1)])
def test_kernels_match_plain_on_the_card(log_n, L, Bt, order):
    """At 2^8 the 2-factor order's rows are 2 words: B's hint loop takes its
    word accesses there. [16, 8, 2^15] and [1, 8, 2^15] are the batch and
    single shapes of B at 2^15: halves, and quarters two blocks an SM."""
    _need_card()
    p = tfast.FastParams.make(log_n, L)
    rng = np.random.default_rng(log_n)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    res = lambda shape: to_torch(rng.integers(0, 1 << 62, shape) % q, "cuda")
    ct_a, ct_b = res((Bt, 2, L, p.n)), res((Bt, 2, L, p.n))
    hb, ha = (tfast.shoup_precompute(res((L, L, p.n)), p.qs) for _ in range(2))
    before = dict(launch.LAUNCHES)
    c = mr.tensor_intt(p.n, p.qs, ct_a, ct_b, order)
    assert all(torch.equal(x, y)
               for x, y in zip(c, mr.tensor_intt_plain(p.n, p.qs, ct_a, ct_b, order)))
    out = mr.digit_relin(p.n, p.qs, *c, hb, ha, order)
    assert torch.equal(out, mr.digit_relin_plain(p.n, p.qs, *c, hb, ha, order))
    # raw hints: the Barrett branch of kernel B, the same residues
    assert torch.equal(mr.digit_relin(p.n, p.qs, *c, hb[0], ha[0], order), out)
    assert launch.LAUNCHES == {**before, "tensor_intt": before["tensor_intt"] + 1,
                               "digit_relin": before["digit_relin"] + 2}


@pytest.mark.cuda
@pytest.mark.parametrize("Bt", [1, 16])
def test_digit_relin_takes_exact_butterflies_from_2e30_on_the_card(Bt):
    """Limbs of 31 bits, where B's lazy butterflies (words below 4q) would
    pass 2^32: each of B's forms at n = 2^15 ([1, 8] quarters; [16, 8]
    halves, and quarters for the tenant form) takes the exact ones, and matches its plain version with Shoup and raw
    hints and over two tenants' hints."""
    _need_card()
    p = tfast.FastParams.make(15, 8, bits=31)
    assert min(p.qs) >= 1 << 30
    rng = np.random.default_rng(31)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    res = lambda shape: to_torch(rng.integers(0, 1 << 62, shape) % q, "cuda")
    c = [res((Bt, 8, p.n)) for _ in range(3)]
    hb, ha = (tfast.shoup_precompute(res((2, 8, 8, p.n)), p.qs) for _ in range(2))
    one_b, one_a = (tuple(x[0] for x in h) for h in (hb, ha))
    want = mr.digit_relin_plain(p.n, p.qs, *c, one_b, one_a, "mxu")
    assert torch.equal(mr.digit_relin(p.n, p.qs, *c, one_b, one_a, "mxu"), want)
    assert torch.equal(mr.digit_relin(p.n, p.qs, *c, one_b[0], one_a[0], "mxu"), want)
    index = to_torch(rng.integers(0, 2, Bt), "cuda")
    assert torch.equal(mr.digit_relin(p.n, p.qs, *c, hb, ha, "mxu", index),
                       mr.digit_relin_plain(p.n, p.qs, *c, hb, ha, "mxu", index))


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt,forms", [(15, 8, 1, ((4, 2), (4, 2))),
                                              (15, 8, 16, ((2, 1), (4, 2))),
                                              (16, 8, 16, ((2, 1), (2, 1))),
                                              (9, 2, 2, ((2, 1), (2, 1)))])
def test_digit_relin_launch_span_names_its_form(log_n, L, Bt, forms):
    """Each card launch of kernel B and of its tenant form carries on its
    launch span the blocks it splits a limb over, and the library reports
    the same form, (parts, blocks an SM): at n = 2^15 quarters two blocks
    an SM for the tenant form, and for one key where they fit one wave
    ([1, 8]), else halves ([16, 8]); halves at 2^16 and below 2^10."""
    _need_card()
    p = tfast.FastParams.make(log_n, L)
    z = lambda *shape: torch.zeros(shape, dtype=torch.int32, device="cuda")
    c = [z(Bt, L, p.n) for _ in range(3)]
    profiling.reset()
    try:
        with profiling.tracing():
            mr.digit_relin(p.n, p.qs, *c, (z(L, L, p.n),) * 2, (z(L, L, p.n),) * 2, "mxu")
            mr.digit_relin(p.n, p.qs, *c, (z(2, L, L, p.n),) * 2, (z(2, L, L, p.n),) * 2, "mxu",
                           z(Bt))
        got = [(s.name, s.attrs) for s in profiling.spans()]
    finally:
        profiling.reset()
    (one, _), (ten, _) = forms
    assert got == [("launch.digit_relin", {"entry": "digit_relin", "parts": one}),
                   ("launch.digit_relin_tenants", {"entry": "digit_relin_tenants", "parts": ten})]
    assert [mr.digit_relin_form(p.n, L, Bt, t) for t in (False, True)] == list(forms)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n,L,Bt", [(14, 3, 1), (15, 18, 1), (15, 8, 16), (16, 8, 4),
                                        (16, 2, 20)])
def test_kernel_a_launch_forms_match_plain_on_the_card(log_n, L, Bt, order):
    """Kernel A at each launch form of zq.cuh launch_grid: a limb over a
    cluster of four blocks ([1, 3, n]; [1, 18, n], the deep chain's first
    level), over two in GridTwo ([16, 8, n] at 2^15: 256 blocks) and in
    GridOne at 2^16 ([4, 8, n]: 32 limbs, more than the clusters of four the
    card runs at once; [20, 2, n]: more than one wave of quarters)."""
    _need_card()
    p = tfast.FastParams.make(log_n, L)
    rng = np.random.default_rng(log_n + L)
    q = np.array(p.qs, dtype=np.int64)[:, None]
    res = lambda shape: to_torch(rng.integers(0, 1 << 62, shape) % q, "cuda")
    ct_a, ct_b = res((Bt, 2, L, p.n)), res((Bt, 2, L, p.n))
    before = launch.LAUNCHES_BY_SHAPE.get(("tensor_intt", Bt, L, p.n), 0)
    got = mr.tensor_intt(p.n, p.qs, ct_a, ct_b, order)
    assert all(torch.equal(x, y)
               for x, y in zip(got, mr.tensor_intt_plain(p.n, p.qs, ct_a, ct_b, order)))
    assert launch.LAUNCHES_BY_SHAPE[("tensor_intt", Bt, L, p.n)] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("log_n", [14, 16])
def test_mul_relin_on_the_card_matches_jax(log_n):
    """At 2^16 each limb of kernels A and B needs two blocks."""
    _need_card()
    p, hb, ha, ct_a, ct_b = _jax_state(log_n, 3, 2, shoup=True, seed=log_n)
    ref = jfast._mul_relin_jnp(p, ct_a, ct_b, hb, ha)
    tp = tfast.FastParams(n=p.n, qs=p.qs, zp=p.zp, impl="pallas")
    out = tfast.mul_relin(tp, to_torch(ct_a, "cuda"), to_torch(ct_b, "cuda"),
                          to_torch(tuple(map(np.asarray, hb)), "cuda"),
                          to_torch(tuple(map(np.asarray, ha)), "cuda"))
    assert out.is_cuda and np.array_equal(to_numpy(out), np.asarray(ref))
