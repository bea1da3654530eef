"""alchemy_tpu_torch.she.hybrid, `garner_pack` and kernel 4
(backend/cuda/mul_relin.py hybrid_digit_stage), kernel 7 with its add-back:
Garner lifting, the joint rescale at its sign boundaries, parameters, keys
and hints, and the hybrid multiply + relinearize against the JAX package
(exact equality)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu.she import hybrid as jhyb
from alchemy_tpu_torch.backend import modarith as ma
from alchemy_tpu_torch.backend.cuda import build, launch
from alchemy_tpu_torch.backend.cuda import mul_relin as mr
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast
from alchemy_tpu_torch.she import hybrid as thyb


def _eq(jax_arr, port):
    return np.array_equal(np.asarray(jax_arr), to_numpy(port))


def _setup(log_n, L, seed, bits=24, impl="pallas"):
    """The same chain, HybridKS, key and hint in both packages from one seed."""
    jp = jfast.FastParams.make(log_n, L, zp=2, impl=impl, bits=bits)
    tp = tfast.FastParams.make(log_n, L, zp=2, bits=bits, impl=impl)
    jhk, thk = jhyb.HybridKS.make(jp, bits=bits), thyb.HybridKS.make(tp, bits=bits)
    rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
    sj, hj = jhyb.hybrid_keygen_hint(jhk, rj)
    st, ht = thyb.hybrid_keygen_hint(thk, rt, device="cpu")
    return jhk, thk, rj, rt, sj, st, hj, ht


def _random_chain(rng, K):
    from alchemy_tpu_torch.nt.primes import is_prime

    chain = []
    while len(chain) < K:
        g = int(rng.integers(1 << 23, 1 << 24))
        if is_prime(g) and g not in chain:
            chain.append(g)
    return tuple(chain)


@pytest.mark.parametrize("chain", ["test_hybrid", "random3", "random5"])
def test_garner_and_extend_digits_match_jax(chain):
    rng = np.random.default_rng(len(chain))
    chain = (97, 113, 193) if chain == "test_hybrid" else _random_chain(rng, int(chain[-1]))
    P = math.prod(chain)
    vals = [(int(rng.integers(0, 1 << 62)) << 62 | int(rng.integers(0, 1 << 62))) % P
            for _ in range(256)]
    res = np.array([[v % g for v in vals] for g in chain], dtype=np.int64)
    xs_j = jhyb.garner_digits(jnp.asarray(res.astype(np.uint32)), chain)
    xs_t = ma.garner_digits(torch.from_numpy(res), chain)
    assert all(np.array_equal(np.asarray(a).astype(np.int64), b.numpy())
               for a, b in zip(xs_j, xs_t))
    # V = Σ x_k·π_k exactly
    pi = ma._garner_tables(chain)[0]
    assert [sum(int(x[i]) * p for x, p in zip(xs_t, pi)) for i in range(256)] == vals
    targets = _random_chain(rng, 3)
    ext_j = jhyb.extend_digits(xs_j, chain, targets)
    ext_t = ma.extend_digits(xs_t, chain, targets)
    assert np.array_equal(np.asarray(ext_j).astype(np.int64), ext_t.numpy())


@pytest.mark.parametrize("L", [4, 5, 8, 16, 18])
def test_hybrid_ks_make_matches_jax(L):
    jp = jfast.FastParams.make(10, L, bits=24, impl="pallas")
    tp = tfast.FastParams.make(10, L, bits=24)
    for kw in ({}, {"bits": 24}, {"dnum": 3, "bits": 24}):
        jhk, thk = jhyb.HybridKS.make(jp, **kw), thyb.HybridKS.make(tp, **kw)
        assert (thk.dnum, thk.ps, thk.groups) == (jhk.dnum, jhk.ps, jhk.groups)
        assert thk.pe.qs == jhk.pe.qs
    assert [thyb.pick_dnum(x) for x in (3, 8, 16, 18)] == [1, 2, 4, 5]


def test_hybrid_keygen_and_hint_match_jax():
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(10, 5, seed=1)
    assert st.dtype == torch.int32 and _eq(sj, st)
    assert ht[0].shape == (2, 8, 1 << 10)          # [dnum, T, n]: groups 3 + 2, K = 3
    assert _eq(hj[0], ht[0]) and _eq(hj[1], ht[1])
    # convert.py carries hybrid hints across, raw [dnum, T, n] and Shoup pairs
    assert all(torch.equal(to_torch(a, "cpu"), b) for a, b in zip(hj, ht))
    for a, b in zip(hj, ht):
        pair_j = to_torch(tuple(map(np.asarray, jfast.shoup_precompute(a, jhk.pe.qs))), "cpu")
        pair_t = tfast.shoup_precompute(b, thk.pe.qs)
        assert all(torch.equal(x, y) for x, y in zip(pair_j, pair_t))
    # a second hint for the same key, from the generators as they are now
    s_int = np.asarray(rj.integers(-1, 2, 1 << 10))
    rt.integers(-1, 2, 1 << 10)
    assert all(_eq(a, b) for a, b in zip(jhyb.hybrid_relin_hint(jhk, s_int, rj),
                                         thyb.hybrid_relin_hint(thk, s_int, rt, device="cpu")))


def _negacyclic_mod2(m1, m2):
    n = len(m1)
    c = np.convolve(m1.astype(np.int64), m2.astype(np.int64))
    return (c[:n] + np.concatenate([c[n:], [0]])) % 2


@pytest.mark.parametrize("L,Bt", [(4, 1), (5, 3), (7, 2), (8, 1)])
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_hybrid_matches_jax(L, Bt, shoup):
    """L = 5 and L = 7 split into uneven groups (3, 2) and (4, 3); the output
    equals the JAX package's bit for bit and decrypts to the negacyclic
    products."""
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(10, L, seed=L + Bt)
    msgs = rj.integers(0, 2, (2, Bt, 1 << 10))
    cts = jnp.stack([jnp.stack([jfast.encrypt(jhk.p, sj, m, rj) for m in row]) for row in msgs])
    ref = jhyb.mul_relin_hybrid(jhk, cts[0], cts[1], *hj)
    if shoup:
        ht = tuple(tfast.shoup_precompute(h, thk.pe.qs) for h in ht)
    out = thyb.mul_relin_hybrid(thk, to_torch(cts[0], "cpu"), to_torch(cts[1], "cpu"), *ht)
    assert out.shape == (Bt, 2, L, 1 << 10) and _eq(ref, out)
    assert torch.equal(out, thyb.mul_relin_hybrid_plain(thk, to_torch(cts[0], "cpu"),
                                                        to_torch(cts[1], "cpu"), *ht))
    for i in range(Bt):
        assert np.array_equal(tfast.decrypt(thk.p, st, out[i]),
                              _negacyclic_mod2(msgs[0, i], msgs[1, i]))
    one = thyb.mul_relin_hybrid(thk, to_torch(cts[0][0], "cpu"), to_torch(cts[1][0], "cpu"), *ht)
    assert torch.equal(one, out[0])                 # a single ciphertext, no batch axis


def _boundary_values(P: int, n: int, rng) -> list[int]:
    """n values in [0, P): the sign test's edges P//2 and P//2 ± 1, 0, 1 and
    P − 1 (every residue q − 1), then random values."""
    edges = [P // 2, P // 2 + 1, P // 2 - 1, 0, 1, P - 1]
    return edges + [(int(rng.integers(0, 1 << 62)) << 62 | int(rng.integers(0, 1 << 62))) % P
                    for _ in range(n - len(edges))]


@pytest.mark.parametrize("L", [5, 7])
def test_garner_pack_plain_matches_jax(L):
    """`garner_pack` on CPU tensors (its plain version) against the JAX
    package's Garner digits of each group, at uneven groups (3, 2) and
    (4, 3) (L = 7, dnum = 2), with zeros, every residue q − 1, and each
    group's edges."""
    _, thk, *_ = _setup(10, L, seed=L)
    assert len(thk.groups[-1]) < len(thk.groups[0])
    n, rng = 1 << 10, np.random.default_rng(L)
    c2c = np.empty((2, L, n), dtype=np.int64)
    off = 0
    for grp in thk.groups:
        vals = [_boundary_values(math.prod(grp), n, rng) for _ in range(2)]
        c2c[:, off:off + len(grp)] = [[[v % g for v in row] for g in grp] for row in vals]
        off += len(grp)
    c2c[0, :, -1] = np.array(thk.p.qs) - 1
    c2c[1, :, -1] = 0
    want, off = [], 0
    for grp in thk.groups:
        want += jhyb.garner_digits(jnp.asarray(c2c[:, off:off + len(grp)].astype(np.uint32)), grp)
        off += len(grp)
    got = mr.garner_pack(n, thk.groups, to_torch(c2c, "cpu"))
    assert got.shape == (2, L, n) and _eq(jnp.stack(want, axis=1), got)


@pytest.mark.parametrize("k_drop", [1, 2, 4])
@pytest.mark.parametrize("zp", [2, 4, 1 << 16])
@pytest.mark.parametrize("add_back", [False, True], ids=["alone", "add_back"])
def test_rescale_plain_matches_jax_at_the_sign_boundaries(k_drop, zp, add_back):
    """`_rescale_joint_plain` (the plain versions of kernel 5 on the dropped
    rows and of kernel 7: their Garner digits and sign terms, the kept rows
    scaled in the NTT domain, and with c01 the add-back of the hybrid
    product) against the JAX package's `_rescale_joint_jnp`, on
    coefficients whose dropped part V takes P//2, P//2 ± 1, 0, 1 and P − 1,
    and keep rows with zeros and q − 1."""
    jp = jfast.FastParams.make(10, 3 + k_drop, zp=zp, bits=30, impl="pallas")
    tp = tfast.FastParams(n=jp.n, qs=jp.qs, zp=zp, impl="pallas")
    keep, drop = jp.qs[:3], jp.qs[3:]
    n, rng, Bt = jp.n, np.random.default_rng(k_drop * zp), 2
    coeff = np.empty((2, Bt, len(jp.qs), n), dtype=np.int64)
    for g in np.ndindex(2, Bt):
        coeff[g][3:] = [[v % q for v in _boundary_values(math.prod(drop), n, rng)] for q in drop]
        coeff[g][:3] = rng.integers(0, np.array(keep)[:, None], (3, n))
    coeff[..., :3, 0], coeff[..., :3, 1] = 0, np.array(keep) - 1
    ct = jfast._ntt_p(jp, jnp.asarray(coeff.astype(np.uint32)))
    ref = np.asarray(jhyb._rescale_joint_jnp(jp, ct, k_drop)).astype(np.int64)   # [2, Bt, 3, n]
    ct_t = to_torch(ct, "cpu")
    if not add_back:
        out = thyb._rescale_joint_plain(tp, ct_t, k_drop)
        assert out.shape == (2, Bt, 3, n) and np.array_equal(ref, to_numpy(out))
        assert torch.equal(thyb.rescale_joint(tp, ct_t, k_drop), out)
        return
    q = np.array(keep, dtype=np.int64)[:, None]
    c01 = rng.integers(0, q, (2, Bt, 3, n))
    c01[..., 0] = q[:, 0] - 1
    want = np.stack([(c01[0] + ref[0]) % q, (c01[1] + ref[1]) % q], axis=1)
    c0, c1 = (to_torch(c, "cpu") for c in c01)
    for plain in (True, False):
        out = thyb._rescale_joint(tp, ct_t, k_drop, plain, (c0, c1))
        assert out.shape == (Bt, 2, 3, n) and np.array_equal(want, to_numpy(out))


@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_hybrid_matches_jax_mxu(shoup):
    """impl="mxu" (the 2-factor order in kernels A, 4, 9 and 7, plain
    versions here) against the JAX package's jnp path; uneven groups 3 + 2."""
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(10, 5, seed=50, impl="mxu")
    assert thk.pe.impl == "mxu" and _eq(sj, st) and _eq(hj[0], ht[0]) and _eq(hj[1], ht[1])
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


@pytest.mark.parametrize("layout", ["strided", "grid"])
@pytest.mark.parametrize("shoup", [False, True], ids=["raw", "shoup"])
def test_mul_relin_hybrid_takes_any_hint_layout(layout, shoup):
    """Hybrid hints that are views (non-contiguous), or in a kernel-grid
    shape [dnum, T, A, B·r], give the same product as contiguous
    [dnum, T, n] hints, and the JAX package's jnp path on the same values,
    at n = 2^6 with uneven groups 3 + 2."""
    from alchemy_tpu_torch.backend.ntt3 import _split3

    jhk, thk, rj, rt, sj, st, hj, ht = _setup(6, 5, seed=66)
    n = 1 << 6
    cts = jnp.stack([jfast.encrypt(jhk.p, sj, rj.integers(0, 2, n), rj) for _ in range(4)])
    a, b = to_torch(cts[:2], "cpu"), to_torch(cts[2:], "cpu")
    if shoup:
        ht = tuple(tfast.shoup_precompute(h, thk.pe.qs) for h in ht)
    A, B, r = _split3(n)

    def view(h):
        if isinstance(h, (tuple, list)):
            return tuple(map(view, h))
        out = h.transpose(0, 1).contiguous().transpose(0, 1)
        assert not out.is_contiguous() and torch.equal(out, h)
        return out if layout == "strided" else out.reshape(*h.shape[:2], A, B * r)

    want = thyb.mul_relin_hybrid(thk, a, b, *ht)
    assert torch.equal(thyb.mul_relin_hybrid(thk, a, b, *map(view, ht)), want)
    assert torch.equal(thyb.mul_relin_hybrid_plain(thk, a, b, *map(view, ht)), want)
    assert _eq(jhyb._mul_relin_hybrid_jnp(jhk, cts[:2], cts[2:], *hj), want)


def _x_pack(x, n):
    """The port's Garner digits x [Bt, L, n] (natural order, rows
    group-major) → the Pallas kernel's x_pack [Bt, A, L·Br]:
    x_pack[b, a, k·Br + m] = x[b, k, a·Br + m] (3-factor grid layout)."""
    from alchemy_tpu_torch.backend.ntt3 import _split3

    A, B, r = _split3(n)
    Bt, L = x.shape[:2]
    return x.reshape(Bt, L, A, B * r).transpose(0, 2, 1, 3).reshape(Bt, A, L * B * r)


@pytest.mark.parametrize("L", [4, 5])
def test_plain_kernel4_matches_pallas_kernel_interpret(monkeypatch, L):
    """Kernel 4's plain version against `hybrid_digit_stage_pallas` run in
    interpret mode (as tests/test_pallas.py runs it), raw and Shoup hints."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.mul_relin_pallas as mrk

    orig = pl.pallas_call
    monkeypatch.setattr(mrk.pl, "pallas_call", lambda *a, **k: orig(*a, **{"interpret": True, **k}))
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(10, L, seed=20 + L)
    n, Bt = 1 << 10, 2
    rng = np.random.default_rng(L)
    c2c = np.stack([rng.integers(0, q, (Bt, n)) for q in thk.p.qs], axis=1)
    x = to_numpy(mr.garner_pack(n, thk.groups, to_torch(c2c, "cpu")))
    hs = tuple(jfast.shoup_precompute(h, jhk.pe.qs) for h in hj)
    hs_t = to_torch(tuple(tuple(map(np.asarray, h)) for h in hs), "cpu")
    for hints_j, hints_t in ((hj, ht), (hs, hs_t)):
        ref = mrk.hybrid_digit_stage_pallas(n, jhk.pe.qs, jhk.groups,
                                            jnp.asarray(_x_pack(x, n)), *hints_j)
        out = mr.hybrid_digit_stage(n, thk.pe.qs, thk.groups, to_torch(x, "cpu"), *hints_t)
        assert out.shape == (2, Bt, len(thk.pe.qs), n) and _eq(ref, out)


def test_plain_kernel4_matches_pallas_kernel_interpret_at_2e16(monkeypatch):
    """n = 2^16, L = 2 (one group of 2, K = 2, T = 4): kernel 4's plain
    version against `hybrid_digit_stage_pallas` in interpret mode, the size
    where the CUDA kernel needs two blocks per limb."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.mul_relin_pallas as mrk

    orig = pl.pallas_call
    monkeypatch.setattr(mrk.pl, "pallas_call", lambda *a, **k: orig(*a, **{"interpret": True, **k}))
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(16, 2, seed=16, bits=30)
    n = 1 << 16
    rng = np.random.default_rng(16)
    c2c = np.stack([rng.integers(0, q, (1, n)) for q in thk.p.qs], axis=1)
    x = to_numpy(mr.garner_pack(n, thk.groups, to_torch(c2c, "cpu")))
    ref = mrk.hybrid_digit_stage_pallas(n, jhk.pe.qs, jhk.groups, jnp.asarray(_x_pack(x, n)), *hj)
    out = mr.hybrid_digit_stage(n, thk.pe.qs, thk.groups, to_torch(x, "cpu"), *ht)
    assert out.shape == (2, 1, 4, n) and _eq(ref, out)


def test_kernel4_constants_match_pallas():
    from alchemy_tpu.backend.pallas.mul_relin_pallas import _hybrid_ext_consts

    _, thk, *_ = _setup(10, 5, seed=0)
    w, ws = _hybrid_ext_consts(thk.groups, thk.pe.qs)
    ours = mr.hybrid_ext_consts(thk.groups, thk.pe.qs)          # [T, 2, L]
    assert np.array_equal(ours[:, 0], w) and np.array_equal(ours[:, 1], ws)


def test_hybrid_wrappers_stay_off_the_card_and_check_inputs(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    thk = thyb.HybridKS.make(tfast.FastParams.make(10, 5, bits=24), bits=24)
    _, (hb, ha) = thyb.hybrid_keygen_hint(thk, np.random.default_rng(3), device="cpu")
    n, T, qs = 1 << 10, len(thk.pe.qs), thk.pe.qs
    x = torch.zeros((2, 5, n), dtype=torch.int32)
    assert mr.hybrid_digit_stage(n, qs, thk.groups, x, hb, ha).shape == (2, 2, T, n)
    ct = torch.zeros((2, 2, 5, n), dtype=torch.int32)
    assert thyb.mul_relin_hybrid(thk, ct, ct, hb, ha).shape == ct.shape
    with pytest.raises(ValueError):              # dtype
        mr.hybrid_digit_stage(n, qs, thk.groups, x.long(), hb, ha)
    with pytest.raises(ValueError):              # digit rows ≠ base limbs
        mr.hybrid_digit_stage(n, qs, thk.groups, x[:, :4].contiguous(), hb, ha)
    with pytest.raises(ValueError):              # hint shape
        mr.hybrid_digit_stage(n, qs, thk.groups, x, hb[:1], ha)
    with pytest.raises(ValueError):              # groups out of chain order
        mr.hybrid_digit_stage(n, qs, thk.groups[::-1], x, hb, ha)
    with pytest.raises(ValueError):              # uneven groups before the last
        mr.hybrid_digit_stage(n, qs, ((qs[0],), qs[1:5]), x, hb, ha)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt", [(14, 5, 2), (15, 16, 2)])
def test_kernel4_matches_plain_on_the_card(log_n, L, Bt):
    _need_card()
    thk = thyb.HybridKS.make(tfast.FastParams.make(log_n, L))
    n, qs = 1 << log_n, thk.pe.qs
    rng = np.random.default_rng(log_n)
    res = lambda chain, shape: to_torch(
        rng.integers(0, 1 << 62, shape) % np.array(chain, dtype=np.int64)[:, None], "cuda")
    x = mr.garner_pack(n, thk.groups, res(thk.p.qs, (Bt, L, n)))
    hb, ha = (res(qs, (thk.dnum, len(qs), n)) for _ in range(2))
    for hints in ((hb, ha), tuple(tfast.shoup_precompute(h, qs) for h in (hb, ha))):
        before = launch.LAUNCHES["hybrid_digit_relin"]
        out = mr.hybrid_digit_stage(n, qs, thk.groups, x, *hints)
        assert launch.LAUNCHES["hybrid_digit_relin"] == before + 1
        assert torch.equal(out, mr.hybrid_digit_stage_plain(n, qs, thk.groups, x, *hints))


@pytest.mark.cuda
def test_mul_relin_hybrid_on_the_card_matches_jax(monkeypatch):
    _need_card()
    # jax runs on the CPU here: its rescale_joint takes the jnp formulation,
    # not the Pallas kernels (which lower only in interpret mode on the CPU)
    monkeypatch.setenv("ALCHEMY_PALLAS_RESCALE", "0")
    jhk, thk, rj, rt, sj, st, hj, ht = _setup(14, 5, seed=14, bits=30)
    cts = jnp.stack([jfast.encrypt(jhk.p, sj, rj.integers(0, 2, jhk.p.n), rj) for _ in range(4)])
    ref = jhyb._mul_relin_hybrid_jnp(jhk, cts[:2], cts[2:], *hj)
    out = thyb.mul_relin_hybrid(thk, to_torch(cts[:2], "cuda"), to_torch(cts[2:], "cuda"),
                                *(h.cuda() for h in ht))
    assert out.is_cuda and _eq(ref, out)


@pytest.mark.cuda
@pytest.mark.parametrize("log_n,L,Bt,order", [(16, 5, 2, "pallas"), (16, 16, 2, "pallas"),
                                              (15, 5, 2, "mxu"), (15, 5, 2, "vpu")])
def test_kernels_4_and_7_match_plain_on_the_card_split(log_n, L, Bt, order):
    """Kernels 4 and 7 (alone and with the add-back; the kept rows any
    uint32 in the NTT domain) with two blocks per limb, at 2^16 and in the
    2-factor slot order; L = 5 gives uneven groups 3 + 2, K = 3."""
    from alchemy_tpu_torch.backend.cuda import rescale as rk

    _need_card()
    thk = thyb.HybridKS.make(tfast.FastParams.make(log_n, L, impl=order))
    n, qs, keep, drop = 1 << log_n, thk.pe.qs, thk.p.qs, thk.ps
    rng = np.random.default_rng(log_n + L)
    res = lambda chain, shape: to_torch(
        rng.integers(0, 1 << 62, shape) % np.array(chain, dtype=np.int64)[:, None], "cuda")
    x = mr.garner_pack(n, thk.groups, res(thk.p.qs, (Bt, L, n)))
    hb, ha = (res(qs, (thk.dnum, len(qs), n)) for _ in range(2))
    for hints in ((hb, ha), tuple(tfast.shoup_precompute(h, qs) for h in (hb, ha))):
        out = mr.hybrid_digit_stage(n, qs, thk.groups, x, *hints, order)
        assert torch.equal(out, mr.hybrid_digit_stage_plain(n, qs, thk.groups, x, *hints, order))
    ntt = to_torch(rng.integers(0, 1 << 32, (2 * Bt, len(qs), n), dtype=np.uint64), "cuda")
    dropped = res(drop, (2 * Bt, len(drop), n))
    c01 = tuple(res(keep, (Bt, L, n)) for _ in range(2))
    for add in (None, c01):
        args = (n, keep, drop, 2, ntt, dropped, order, add)
        before = launch.LAUNCHES["rescale_fwd"]
        assert torch.equal(rk.rescale_fwd(*args), rk.rescale_fwd_plain(*args))
        assert launch.LAUNCHES["rescale_fwd"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("L,dnum,Bt", [(16, 4, 1), (16, 4, 16), (18, None, 2), (7, 2, 2)])
def test_garner_pack_matches_plain_on_the_card(L, dnum, Bt):
    """`garner_pack` at n = 2^15: the hybrid cells' L = 16, dnum = 4 at one
    and 16 ciphertexts, and uneven chains (L = 18: 4 × 4 + 2; L = 7: 4 + 3),
    with every residue q − 1 and zeros; one launch each, counted by shape."""
    _need_card()
    thk = thyb.HybridKS.make(tfast.FastParams.make(15, L), dnum=dnum)
    n, alpha = 1 << 15, len(thk.groups[0])
    q = np.array(thk.p.qs, dtype=np.int64)[:, None]
    c2c = np.random.default_rng(L + Bt).integers(0, 1 << 62, (Bt, L, n)) % q
    c2c[:, :, 0], c2c[:, :, 1] = q[:, 0] - 1, 0
    c2c = to_torch(c2c, "cuda")
    before = launch.LAUNCHES_BY_SHAPE.get(("garner_pack", Bt, L, alpha, n), 0)
    out = mr.garner_pack(n, thk.groups, c2c)
    assert launch.LAUNCHES_BY_SHAPE[("garner_pack", Bt, L, alpha, n)] == before + 1
    assert torch.equal(out, mr.garner_pack_plain(n, thk.groups, c2c))


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["mxu", "pallas"])
def test_mul_relin_hybrid_matches_plain_on_the_card_eager_and_in_a_graph(order):
    """`mul_relin_hybrid` at the hybrid cells' chain (n = 2^15, L = 16,
    dnum = 4, K = 4), two ciphertexts, against `mul_relin_hybrid_plain`:
    called eagerly (five launches: A, garner_pack, 4, the inverse transform
    of the dropped rows, [2·Bt, K, n], and 7) and captured in a CUDA graph, replayed on new inputs copied into the
    captured ones."""
    _need_card()
    hk = thyb.HybridKS.make(tfast.FastParams.make(15, 16, impl=order), dnum=4)
    rng = np.random.default_rng(16)
    s, hints = thyb.hybrid_keygen_hint(hk, rng, device="cuda")
    cts = [torch.stack([tfast.encrypt(hk.p, s, rng.integers(0, 2, hk.p.n), rng)
                        for _ in range(4)]) for _ in range(2)]
    a, b = cts[0][:2].clone(), cts[0][2:].clone()
    counted = lambda: sum(launch.LAUNCHES.values())
    before, shapes = counted(), dict(launch.LAUNCHES_BY_SHAPE)
    out = thyb.mul_relin_hybrid(hk, a, b, *hints)
    assert counted() - before == 5
    # the inverse transform takes the K = 4 dropped rows of each (t0, t1) row alone
    inverse = launch.GRID_NAMES[order][1]
    for key in ((inverse, 4, 4, hk.p.n), ("rescale_fwd", 4, 16, 4, hk.p.n)):
        assert launch.LAUNCHES_BY_SHAPE[key] == shapes.get(key, 0) + 1
    assert torch.equal(out, thyb.mul_relin_hybrid_plain(hk, a, b, *hints))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        thyb.mul_relin_hybrid(hk, a, b, *hints)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = thyb.mul_relin_hybrid(hk, a, b, *hints)
    for new in (cts[1], cts[0]):
        a.copy_(new[:2])
        b.copy_(new[2:])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, thyb.mul_relin_hybrid_plain(hk, a, b, *hints))
