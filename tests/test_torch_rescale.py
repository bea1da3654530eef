"""alchemy_tpu_torch kernels 5, 6 and 7 (backend/cuda/rescale.py), the
standalone transforms `fast._ntt_p`/`_intt_p` and `hybrid.rescale_joint`:
the plain versions against the JAX package's Pallas kernels in interpret
mode and its jnp formulations (exact equality)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu.she import hybrid as jhyb
from alchemy_tpu_torch.backend.cuda import build, launch
from alchemy_tpu_torch.backend.cuda import rescale as rk
from alchemy_tpu_torch.backend.ntt3 import intt3, ntt3
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.she import fast as tfast
from alchemy_tpu_torch.she import hybrid as thyb


#: kernels 6 and 5, the standalone transforms of the 3-factor slot order
NTT3_GRID, INTT3_GRID = rk.grid_transforms("pallas")


def _eq(jax_arr, port):
    return np.array_equal(np.asarray(jax_arr), to_numpy(port))


def _rows(p, G, seed, hi=None):
    """[G, T, n] uint32 rows: residues mod each limb, or any uint32 below hi."""
    rng = np.random.default_rng(seed)
    if hi is not None:
        return rng.integers(0, hi, (G, len(p.qs), p.n), dtype=np.uint64).astype(np.uint32)
    return np.stack([rng.integers(0, q, (G, p.n)) for q in p.qs], axis=1).astype(np.uint32)


@pytest.fixture
def interpret(monkeypatch):
    """Run the Pallas kernels in interpret mode, as tests/test_pallas.py does."""
    from jax.experimental import pallas as pl

    import alchemy_tpu.backend.pallas.rescale_pallas as rpk

    orig = pl.pallas_call
    monkeypatch.setattr(rpk.pl, "pallas_call", lambda *a, **k: orig(*a, **{"interpret": True, **k}))
    return rpk


@pytest.mark.parametrize("log_n,L", [(10, 3), (11, 4)])
def test_plain_kernels_5_and_6_match_pallas_kernels_interpret(interpret, log_n, L):
    p = jfast.FastParams.make(log_n, L, impl="pallas")
    x = _rows(p, 2, seed=log_n)
    y = interpret.ntt3_grid_pallas(p.n, p.qs, jnp.asarray(x))
    assert _eq(y, NTT3_GRID(p.n, p.qs, to_torch(x, "cpu")))
    assert _eq(interpret.intt3_grid_pallas(p.n, p.qs, y),
               INTT3_GRID(p.n, p.qs, to_torch(y, "cpu")))
    # the port's kernels reduce any uint32 input first, as ntt3/intt3 do
    u = _rows(p, 2, seed=1, hi=1 << 32)
    q = np.array(p.qs, dtype=np.uint64)[:, None]
    for fn, plain in ((NTT3_GRID, ntt3), (INTT3_GRID, intt3)):
        want = plain(torch.from_numpy((u % q).astype(np.int64)), p.n, p.qs)
        got = to_numpy(fn(p.n, p.qs, to_torch(u, "cpu"))).astype(np.int64)
        assert np.array_equal(got, want.numpy())


def test_kernels_5_and_6_match_pallas_kernels_interpret_at_2e16(interpret):
    """n = 2^16 (the radix-4 slot order, and the size where the CUDA
    kernels split each limb over two blocks): the wrappers (plain versions
    here) against the Pallas kernels in interpret mode."""
    p = jfast.FastParams.make(16, 2, impl="pallas")
    x = _rows(p, 1, seed=16)
    y = interpret.ntt3_grid_pallas(p.n, p.qs, jnp.asarray(x))
    assert _eq(y, NTT3_GRID(p.n, p.qs, to_torch(x, "cpu")))
    assert _eq(interpret.intt3_grid_pallas(p.n, p.qs, y),
               INTT3_GRID(p.n, p.qs, to_torch(np.asarray(y), "cpu")))


@pytest.mark.parametrize("log_n,L,k_drop", [(10, 4, 1), (10, 6, 2), (11, 5, 3)])
def test_rescale_joint_matches_pallas_interpret_and_jnp(interpret, log_n, L, k_drop):
    """Kernels 5 → sign terms → 7 (plain versions here) against
    `rescale_joint_pallas` (kernels C and D in interpret mode) and against
    `_rescale_joint_jnp`."""
    p = jfast.FastParams.make(log_n, L, zp=2, impl="pallas")
    tp = tfast.FastParams(n=p.n, qs=p.qs, zp=2, impl="pallas")
    ct = _rows(p, 2, seed=L)
    out = thyb.rescale_joint(tp, to_torch(ct, "cpu"), k_drop)
    assert out.shape == (2, L - k_drop, p.n)
    assert _eq(interpret.rescale_joint_pallas(p, jnp.asarray(ct), k_drop), out)
    assert _eq(jhyb._rescale_joint_jnp(p, jnp.asarray(ct), k_drop), out)


def test_rescale_joint_matches_pallas_interpret_at_2e16(interpret):
    """n = 2^16, keep L = 2, K = 2: kernels 5 → sign terms → 7 (plain
    versions here) against `rescale_joint_pallas` in interpret mode, the size
    where the CUDA kernel 7 needs two blocks per limb."""
    p = jfast.FastParams.make(16, 4, zp=2, impl="pallas")
    ct = _rows(p, 1, seed=16)
    out = thyb.rescale_joint(tfast.FastParams(n=p.n, qs=p.qs, zp=2, impl="pallas"),
                             to_torch(ct, "cpu"), 2)
    assert out.shape == (1, 2, p.n) and _eq(interpret.rescale_joint_pallas(p, jnp.asarray(ct), 2), out)


@pytest.mark.parametrize("k_drop", [1, 2])
def test_rescale_joint_matches_jnp_mxu(k_drop):
    """impl="mxu": kernels 9 → sign terms → 7 in the 2-factor order (plain
    versions here) against the JAX package's `rescale_joint` (its jnp path
    at that impl); at k_drop = 1 it equals the port's `fast.rescale`."""
    jp = jfast.FastParams.make(10, 5, zp=2, impl="mxu")
    tp = tfast.FastParams(n=jp.n, qs=jp.qs, zp=2)
    ct = _rows(jp, 3, seed=k_drop)
    out = thyb.rescale_joint(tp, to_torch(ct, "cpu"), k_drop)
    assert out.shape == (3, 5 - k_drop, jp.n)
    assert _eq(jhyb.rescale_joint(jp, jnp.asarray(ct), k_drop), out)
    assert torch.equal(out, thyb._rescale_joint_plain(tp, to_torch(ct, "cpu"), k_drop))
    if k_drop == 1:
        assert torch.equal(out, tfast.rescale(tp, to_torch(ct, "cpu"), 1))


#: (log2 n, keep limbs, dropped limbs) of the plain flow's tests against the
#: JAX package: the rings of the tests above at K = 1–4, and 2^16 with a
#: short chain
PLAIN_FLOW_CASES = [(log_n, L, k) for log_n, L in ((10, 3), (11, 2)) for k in (1, 2, 3, 4)] + [
    (16, 2, 2)]


@pytest.mark.parametrize("order", ["mxu", "pallas", "vpu"])
@pytest.mark.parametrize("log_n,L,k_drop", PLAIN_FLOW_CASES)
def test_rescale_joint_plain_flow_matches_jnp_in_every_order(log_n, L, k_drop, order):
    """The joint rescale as the plain versions compute it (only the dropped
    rows inverted; the correction transformed alone and the kept rows scaled
    by P⁻¹ in the NTT domain) against the JAX package's inverse/forward round
    trip, `_rescale_joint_jnp` and (off 2^16, where its Pallas kernels would
    need a TPU) `rescale_joint`, exactly, in every slot order."""
    jp = jfast.FastParams.make(log_n, L + k_drop, zp=2, impl=order)
    tp = tfast.FastParams(n=jp.n, qs=jp.qs, zp=2, impl=order)
    ct = _rows(jp, 2, seed=log_n + k_drop)
    out = thyb._rescale_joint_plain(tp, to_torch(ct, "cpu"), k_drop)
    assert out.shape == (2, L, jp.n)
    assert _eq(jhyb._rescale_joint_jnp(jp, jnp.asarray(ct), k_drop), out)
    if log_n < 14:
        assert _eq(jhyb.rescale_joint(jp, jnp.asarray(ct), k_drop), out)
    assert torch.equal(thyb.rescale_joint(tp, to_torch(ct, "cpu"), k_drop), out)


@pytest.mark.parametrize("order", ["mxu", "pallas", "vpu"])
def test_rescale_inverts_only_the_dropped_rows(monkeypatch, order):
    """Inside `_rescale_joint` the plain inverse transform receives the
    dropped rows alone, [G, K, n], never [G, T, n], and the plain forward
    transform the correction of the kept rows, [G, L, n]: in
    `rescale_joint`, its plain version, the hybrid product's add-back and
    `fast.rescale` (one dropped row a limb)."""
    fwd, inv, bcast = launch.plain_transforms(order)
    seen = {"fwd": [], "inv": []}

    def recorded(name, f):
        def call(x, n, qs):
            seen[name].append(tuple(x.shape))
            return f(x, n, qs)
        return call

    def shapes(*calls):
        seen.update(fwd=[], inv=[])
        for call in calls:
            call()
        return seen

    monkeypatch.setitem(launch.ORDERS, order,
                        (recorded("fwd", fwd), recorded("inv", inv), bcast))
    p = tfast.FastParams.make(10, 6, impl=order)
    n, ct = p.n, to_torch(_rows(p, 4, seed=6), "cpu")
    for k_drop in (1, 3):
        c = to_torch(_rows(tfast.FastParams(n=n, qs=p.qs[:-k_drop]), 2, seed=k_drop), "cpu")
        assert shapes(lambda: thyb._rescale_joint_plain(p, ct, k_drop),
                      lambda: thyb.rescale_joint(p, ct, k_drop),
                      lambda: tfast._rescale_joint(p, ct, k_drop, True, (c, c))) == {
            "inv": [(4, k_drop, n)] * 3, "fwd": [(4, 6 - k_drop, n)] * 3}
    assert shapes(lambda: tfast.rescale(p, ct[:2], 3)) == {
        "inv": [(2, 1, n)] * 3, "fwd": [(2, 5, n), (2, 4, n), (2, 3, n)]}


def test_kernel7_constants_match_pallas(interpret):
    p = jfast.FastParams.make(10, 6)
    keep, drop = p.qs[:4], p.qs[4:]
    rsc, w, ws = interpret._rescale_consts(keep, drop)
    ours = rk.rescale_consts(keep, drop)                       # [L, 4 + 2K]
    assert np.array_equal(ours[:, :4], rsc)
    assert np.array_equal(ours[:, 4:6], w) and np.array_equal(ours[:, 6:], ws)


@pytest.mark.parametrize("k_drop", [1, 2])
def test_rescale_joint_matches_jnp_and_fast_rescale(k_drop):
    """On a fresh ciphertext and a batch with leading dims; at k_drop = 1
    the joint rescale equals the port's limb-by-limb `fast.rescale`."""
    jp = jfast.FastParams.make(10, 4, zp=2, impl="pallas")
    tp = tfast.FastParams(n=jp.n, qs=jp.qs, zp=2, impl="pallas")
    rng = np.random.default_rng(k_drop)
    s = tfast.keygen(tp, rng, device="cpu")
    msgs = rng.integers(0, 2, (2, 3, tp.n))
    ct = torch.stack([torch.stack([tfast.encrypt(tp, s, m, rng) for m in row]) for row in msgs])
    out = thyb.rescale_joint(tp, ct, k_drop)
    assert out.shape == (2, 3, 2, 4 - k_drop, tp.n)
    assert _eq(jhyb._rescale_joint_jnp(jp, jnp.asarray(to_numpy(ct)), k_drop), out)
    assert torch.equal(out, thyb._rescale_joint_plain(tp, ct, k_drop))
    down = tfast.FastParams(n=tp.n, qs=tp.qs[:-k_drop], zp=2, impl="pallas")
    assert np.array_equal(tfast.decrypt(down, s[:-k_drop], out[1, 2]), msgs[1, 2])
    if k_drop == 1:
        assert torch.equal(out, tfast.rescale(tp, ct, 1))
    with pytest.raises(ValueError):
        thyb.rescale_joint(tfast.FastParams(n=tp.n, qs=tp.qs, zp=1 << 17, impl="pallas"), ct,
                           k_drop)


def test_ntt_p_intt_p_match_jax():
    jp = jfast.FastParams.make(10, 3, impl="pallas")
    tp = tfast.FastParams(n=jp.n, qs=jp.qs, zp=jp.zp, impl="pallas")
    x = _rows(jp, 4, seed=5).reshape(2, 2, 3, jp.n)            # leading dims fold through
    y = tfast._ntt_p(tp, to_torch(x, "cpu"))
    assert y.shape == x.shape and _eq(jfast._ntt_p(jp, jnp.asarray(x)), y)
    assert _eq(jfast._intt_p(jp, jnp.asarray(to_numpy(y))), tfast._intt_p(tp, y))
    assert np.array_equal(to_numpy(tfast._intt_p(tp, y)), x)


def test_rescale_wrappers_stay_off_the_card_and_check_inputs(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(build, "library", no_library)
    p = tfast.FastParams.make(10, 4)
    n, qs = p.n, p.qs
    x = torch.zeros((2, 4, n), dtype=torch.int32)
    assert NTT3_GRID(n, qs, x).shape == INTT3_GRID(n, qs, x).shape == x.shape
    # the inverse of the last rows of each group alone, as rescale_joint takes them
    assert INTT3_GRID(n, qs[3:], x).shape == NTT3_GRID(n, qs[1:], x).shape[:1] + (1, n)
    c = torch.zeros((1, 3, n), dtype=torch.int32)
    d = torch.zeros((2, 1, n), dtype=torch.int32)
    assert rk.rescale_fwd(n, qs[:3], qs[3:], 2, x, d).shape == (2, 3, n)
    assert rk.rescale_fwd(n, qs[:3], qs[3:], 2, x, d, "pallas", (c, c)).shape == (1, 2, 3, n)
    s = tfast.keygen(p, np.random.default_rng(0), device="cpu")
    ct = tfast.encrypt(p, s, np.zeros(n, dtype=np.int64), np.random.default_rng(1))
    down = tfast.FastParams(n=n, qs=qs[:-1], zp=2)
    assert not tfast.decrypt(down, s[:-1], tfast.rescale(p, ct, 1)).any()
    with pytest.raises(ValueError):
        NTT3_GRID(n, qs, x.long())
    with pytest.raises(ValueError):
        INTT3_GRID(n, qs, x[:, :3])                             # not contiguous, wrong T
    with pytest.raises(ValueError):
        INTT3_GRID(n, qs, x[0])
    with pytest.raises(ValueError):                             # fewer rows than limbs
        INTT3_GRID(n, qs, x[:, :3].contiguous())
    with pytest.raises(ValueError):
        rk.rescale_fwd(n, qs[:3], qs[3:], 2, x[:, :3].contiguous(), d)
    with pytest.raises(ValueError):                             # every row of a group
        rk.rescale_fwd(n, qs[:3], qs[3:], 2, x, x)
    with pytest.raises(ValueError):                             # c1 of the wrong shape
        rk.rescale_fwd(n, qs[:3], qs[3:], 2, x, d, "pallas", (c, c[:, :2].contiguous()))
    with pytest.raises(ValueError):                             # an odd number of rows
        rk.rescale_fwd(n, qs[:3], qs[3:], 2, x[:1], d[:1], "pallas", (c[:0], c[:0]))
    # what only the card path refuses: zp, and more dropped limbs than zq.cuh kMaxDigits
    with pytest.raises(ValueError, match="power-of-two zp"):
        rk.drop_consts(qs[3:], 6)
    with pytest.raises(NotImplementedError, match="1 to 8 limbs"):
        rk.drop_consts(tfast.FastParams.make(10, 9).qs, 2)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _grid_names(order):
    """Launch counters of the (inverse, forward) transforms of a slot order."""
    return {"mxu": ("intt2_grid", "ntt2_grid"), "vpu": ("intt_vpu_grid", "ntt_vpu_grid"),
            "pallas": ("intt_grid", "ntt_grid")}[order]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n,L,G", [(14, 5, 1), (14, 5, 3), (15, 20, 1), (15, 20, 2),
                                       (15, 20, 4)])
def test_kernels_5_6_7_match_plain_on_the_card(log_n, L, G, order):
    """Kernels 5 and 6 (8 and 9 in the mxu order) at every launch form of
    rescale.cu launch_grid: a limb over four blocks ([1, 5, n], [3, 5, n] and
    [1, 20, n]; the inverse on [1, 20, n] where the card runs 20 clusters of
    four at once), over two in GridOne ([2, 20, n]) and GridTwo ([4, 20, n]:
    160 blocks); both on the window of the last K = 1 and 4 rows of each
    group, read in place; and the joint rescale (the inverse on its dropped
    rows alone, then kernel 7)."""
    _need_card()
    p = tfast.FastParams.make(log_n, L, impl=order)
    x = to_torch(_rows(p, G, seed=log_n, hi=1 << 32), "cuda")
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms(order), rk.grid_transforms(order, True)
    inv_name, fwd_name = _grid_names(order)
    before, shapes = dict(launch.LAUNCHES), dict(launch.LAUNCHES_BY_SHAPE)
    assert torch.equal(fwd(p.n, p.qs, x), fwd_plain(p.n, p.qs, x))
    assert torch.equal(inv(p.n, p.qs, x), inv_plain(p.n, p.qs, x))
    for k in (1, 4):
        window = inv(p.n, p.qs[-k:], x)
        assert window.shape == (G, k, p.n)
        assert torch.equal(window, inv_plain(p.n, p.qs[-k:], x[:, -k:].contiguous()))
        assert torch.equal(fwd(p.n, p.qs[-k:], x), fwd_plain(p.n, p.qs[-k:], x))
    ct = to_torch(_rows(p, G, seed=1), "cuda")
    for k_drop in (1, 4):
        assert torch.equal(thyb.rescale_joint(p, ct, k_drop),
                           thyb._rescale_joint_plain(p, ct, k_drop))
    assert launch.LAUNCHES == {**before, inv_name: before[inv_name] + 5,
                               fwd_name: before[fwd_name] + 3,
                               "rescale_fwd": before["rescale_fwd"] + 2}
    for k in (1, 4):
        key = (inv_name, G, k, p.n)
        assert launch.LAUNCHES_BY_SHAPE[key] == shapes.get(key, 0) + 2


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("G", [1, 8, 12])
def test_kernels_5_6_match_plain_on_the_card_at_2e16(G, order):
    """n = 2^16 (one 1024-thread block an SM) in every slot order: a limb
    over four blocks ([1, 3, n]; [8, 3, n], the inverse where the card runs
    24 clusters of four at once) and over two ([12, 3, n]); the inverse
    also on the last two rows of each group."""
    _need_card()
    p = tfast.FastParams.make(16, 3, impl=order)
    x = to_torch(_rows(p, G, seed=16, hi=1 << 32), "cuda")
    (fwd, inv), (fwd_plain, inv_plain) = rk.grid_transforms(order), rk.grid_transforms(order, True)
    inv_name, fwd_name = _grid_names(order)
    before = dict(launch.LAUNCHES)
    assert torch.equal(fwd(p.n, p.qs, x), fwd_plain(p.n, p.qs, x))
    assert torch.equal(inv(p.n, p.qs, x), inv_plain(p.n, p.qs, x))
    assert torch.equal(inv(p.n, p.qs[1:], x), inv_plain(p.n, p.qs[1:], x))
    assert launch.LAUNCHES == {**before, inv_name: before[inv_name] + 2,
                               fwd_name: before[fwd_name] + 1}
    assert launch.LAUNCHES_BY_SHAPE[inv_name, G, 3, p.n] >= 1
    assert launch.LAUNCHES_BY_SHAPE[inv_name, G, 2, p.n] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["mxu", "pallas"])
@pytest.mark.parametrize("L,k_drop", [(18, 1), (18, 2), (12, 1), (9, 1), (3, 1)])
def test_fast_rescale_kernel_path_matches_the_loop_on_the_card(L, k_drop, order):
    """`fast.rescale` at widths of the depth-16 chain (its 18 primes cut to
    L), one ciphertext [2, L, 2^15]: the kernel path equals `fast.rescale`
    on CPU copies (the plain versions, which the CPU tests hold against the
    JAX package), residue for residue, and launches one inverse transform
    of the dropped row alone, [2, 1, n], and one kernel 7 at K = 1 a dropped
    limb. A zp above kernel 7's
    `ZP_MAX` raises on the card."""
    from dataclasses import replace

    _need_card()
    p = tfast.FastParams.make(15, 18, impl=order)
    p = replace(p, qs=p.qs[:L])
    ct = to_torch(_rows(p, 2, seed=L + k_drop), "cuda")
    inv_name, _ = _grid_names(order)
    before, shapes = dict(launch.LAUNCHES), dict(launch.LAUNCHES_BY_SHAPE)
    got = tfast.rescale(p, ct, k_drop)
    assert launch.LAUNCHES == {**before, inv_name: before[inv_name] + k_drop,
                               "rescale_fwd": before["rescale_fwd"] + k_drop}
    for i in range(k_drop):
        key = ("rescale_fwd", 2, L - 1 - i, 1, p.n)
        assert launch.LAUNCHES_BY_SHAPE[key] == shapes.get(key, 0) + 1
    key = (inv_name, 2, 1, p.n)                     # the dropped row alone, each limb
    assert launch.LAUNCHES_BY_SHAPE[key] == shapes.get(key, 0) + k_drop
    assert got.is_cuda and got.shape == (2, L - k_drop, p.n)
    assert torch.equal(got.cpu(), tfast.rescale(p, ct.cpu(), k_drop))
    with pytest.raises(ValueError, match="power-of-two zp"):
        tfast.rescale(replace(p, zp=2 * rk.ZP_MAX), ct, k_drop)


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["mxu", "pallas", "vpu"])
def test_fast_rescale_on_the_card_matches_jax(order):
    """`fast.rescale` on the card (each limb: the inverse transform of the
    dropped row alone, then kernel 7 on the kept rows in the NTT domain)
    against the JAX package's limb-by-limb `fast.rescale`, two limbs off a
    ciphertext [2, 6, 2^14]."""
    _need_card()
    jp = jfast.FastParams.make(14, 6, zp=2, impl=order)
    ct = _rows(jp, 2, seed=14)
    out = tfast.rescale(tfast.FastParams(n=jp.n, qs=jp.qs, zp=2, impl=order),
                        to_torch(ct, "cuda"), 2)
    assert out.is_cuda and _eq(jfast.rescale(jp, jnp.asarray(ct), 2), out)


def _kernel_7_inputs(log_n: int, L: int, K: int, G: int, device: str):
    """(keep, drop, ntt, dropped, (c0, c1)) as rescale_joint and the hybrid
    product hand them to kernel 7: rows ntt [G, L + K, n] of any uint32 (the
    kept rows as kernel 4 may leave them: not reduced), canonical
    coefficients dropped [G, K, n] whose first coefficients put the dropped
    part V at P//2, P//2 + 1, 0 and P − 1, and canonical c0, c1 [G/2, L, n]."""
    import math

    chain = tfast.FastParams.make(log_n, L + K).qs
    keep, drop = chain[:L], chain[L:]
    ntt = _rows(tfast.FastParams(n=1 << log_n, qs=chain), G, seed=log_n + L, hi=1 << 32)
    dropped = _rows(tfast.FastParams(n=1 << log_n, qs=drop), G, seed=log_n + K).astype(np.int64)
    P = math.prod(drop)
    for i, v in enumerate((P // 2, P // 2 + 1, 0, P - 1)):
        dropped[:, :, i] = [v % g for g in drop]
    c = _rows(tfast.FastParams(n=1 << log_n, qs=keep), 2 * (G // 2), seed=K)
    c01 = tuple(to_torch(h, device) for h in (c[:G // 2], c[G // 2:]))
    return keep, drop, to_torch(ntt, device), to_torch(dropped, device), c01


#: (log2 n, L, K, G) of kernel 7's card tests
KERNEL_7_SHAPES = [(8, 3, 2, 2), (14, 5, 3, 2), (15, 3, 3, 2), (15, 9, 3, 2), (15, 16, 4, 2),
                   (15, 18, 4, 2), (15, 16, 4, 32), (16, 4, 2, 3), (16, 4, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["pallas", "mxu", "vpu"])
@pytest.mark.parametrize("log_n,L,K,G,add_back",
                         [(*shape, add) for shape in KERNEL_7_SHAPES for add in (False, True)
                          if not (add and shape[3] % 2)])
def test_kernel_7_matches_plain_on_the_card(log_n, L, K, G, order, add_back):
    """Kernel 7, its prologue (the dropped rows' Garner digits, sign terms
    and correction) split over a cluster pair, the kept rows read in the NTT
    domain as any uint32 in its store, in both launch shapes (512 threads at
    n ≤ 2^15, 1024 at 2^16; [2, 3–18, n] with K = 3–4 the deep chain's
    levels, [2, 16, n] a single hybrid product's, [32, 16, n] the batch's),
    alone and adding (c0, c1) as it stores; at 2^8 the 2-factor order's rows
    are 2 words, and the slot-order store takes word accesses."""
    _need_card()
    keep, drop, ntt, dropped, c01 = _kernel_7_inputs(log_n, L, K, G, "cuda")
    args = (1 << log_n, keep, drop, 2, ntt, dropped, order, c01 if add_back else None)
    before = launch.LAUNCHES_BY_SHAPE.get(("rescale_fwd", G, L, K, 1 << log_n), 0)
    out = rk.rescale_fwd(*args)
    assert out.shape == ((G // 2, 2, L, 1 << log_n) if add_back else (G, L, 1 << log_n))
    assert torch.equal(out, rk.rescale_fwd_plain(*args))
    assert launch.LAUNCHES_BY_SHAPE[("rescale_fwd", G, L, K, 1 << log_n)] == before + 1
    # the kept rows not reduced give what their residues give
    q = torch.tensor(keep + drop, dtype=torch.int64, device="cuda")[:, None]
    reduced = (ntt.long() & 0xFFFFFFFF) % q
    assert not torch.equal(reduced.int(), ntt)
    assert torch.equal(out, rk.rescale_fwd(1 << log_n, keep, drop, 2, reduced.int(), *args[5:]))


@pytest.mark.cuda
@pytest.mark.parametrize("zp", [4, 1 << 16])
def test_kernel_7_takes_any_power_of_two_zp_on_the_card(zp):
    _need_card()
    keep, drop, ntt, dropped, c01 = _kernel_7_inputs(15, 16, 4, 2, "cuda")
    for add in (None, c01):
        args = (1 << 15, keep, drop, zp, ntt, dropped, "mxu", add)
        assert torch.equal(rk.rescale_fwd(*args), rk.rescale_fwd_plain(*args))


@pytest.mark.cuda
def test_kernel_7_time_at_the_hybrid_shape_on_the_card():
    """Kernel 7 alone at the hybrid batch's shape [32, 16, n = 2^15], K = 4,
    "mxu", with and without the add-back: device ms a launch over 50
    launches (CUDA events), printed beside the card; checked against the
    plain version."""
    _need_card()
    keep, drop, ntt, dropped, c01 = _kernel_7_inputs(15, 16, 4, 32, "cuda")
    times = {}
    for name, add in (("alone", None), ("add_back", c01)):
        args = (1 << 15, keep, drop, 2, ntt, dropped, "mxu", add)
        assert torch.equal(rk.rescale_fwd(*args), rk.rescale_fwd_plain(*args))
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            rk.rescale_fwd(*args)
        end.record()
        torch.cuda.synchronize()
        times[name] = start.elapsed_time(end) / 50
    print(f"[kernel 7] [32, 16, 4] n=2^15 mxu on {torch.cuda.get_device_name()}: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items()))


@pytest.mark.cuda
def test_rescale_joint_on_the_card_matches_jax():
    _need_card()
    jp = jfast.FastParams.make(14, 6, zp=2, impl="pallas")
    ct = _rows(jp, 2, seed=3)
    out = thyb.rescale_joint(tfast.FastParams(n=jp.n, qs=jp.qs, zp=2, impl="pallas"),
                             to_torch(ct, "cuda"), 2)
    assert out.is_cuda and _eq(jhyb._rescale_joint_jnp(jp, jnp.asarray(ct), 2), out)
