"""alchemy_tpu_torch.parallel on 8 gloo ranks on the CPU: one case per test
of tests/test_parallel.py. The inputs come from a seeded
`np.random.default_rng` (ciphertexts and hints through the JAX package's
`fast`), the JAX results from its 8-device CPU mesh (tests/conftest.py),
the port's from the ranks of one world of 8 processes (mesh (2, 2, 2)) that
serves every case of this file; the two must be equal (tolerance 0)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_rank_cases as R
from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.backend.xla import mulmod
from alchemy_tpu.parallel.dist import (
    DistConfig,
    make_dist_mul_relin,
    make_dist_mul_relin_hybrid,
    make_dist_ntt,
    make_dist_rescale,
)
from alchemy_tpu.parallel.mesh import make_mesh
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams
from alchemy_tpu_torch.parallel import dist as tdist
from alchemy_tpu_torch.parallel.multihost import LocalWorld

MESH = (2, 2, 2)
#: a hang or a dead rank fails the case instead of running out the clock
CALL_S = 240


@pytest.fixture(scope="module")
def world():
    with LocalWorld(8, backend="gloo", timeout=CALL_S) as w:
        yield w


def setup(log_n=8, nlimb=4, n1=None):
    p = FastParams.make(log_n, nlimb, zp=2)
    n1 = n1 or (1 << (log_n // 2))
    return p, DistConfig(p=p, n1=n1, n2=p.n // n1), make_mesh(MESH)


def args(cfg):
    """The port's DistConfig as the rank functions take it."""
    p = cfg.p
    return (MESH, p.n, p.qs, p.impl, cfg.n1)


def on_ranks(world, fn, *a):
    return world.run(fn, *a)[0]


def to_dist_layout(coeffs, cfg):
    """coeff-index order → (j2, j1) storage order."""
    n1, n2 = cfg.n1, cfg.n2
    j2, j1 = np.divmod(np.arange(cfg.p.n), n1)
    return coeffs[..., j1 * n2 + j2]


def from_dist_layout(stored, cfg):
    n1, n2 = cfg.n1, cfg.n2
    j1, j2 = np.divmod(np.arange(cfg.p.n), n2)
    return stored[..., j2 * n1 + j1]


def residues(rng, p, B):
    return np.stack(
        [np.stack([rng.integers(0, q, p.n) for q in p.qs]) for _ in range(B)]
    ).astype(np.uint32)


def test_dist_tables_match_jax():
    """The vectorised tables equal the JAX package's per-entry modular
    powers, key by key."""
    from alchemy_tpu.parallel.dist import dist_tables

    for log_n, nlimb, n1 in ((8, 4, 16), (7, 3, 8), (6, 2, 4)):
        p, cfg, _ = setup(log_n, nlimb, n1)
        want = dist_tables(cfg)
        got = tdist.dist_tables(R._cfg(p.n, p.qs, p.impl, n1))
        assert got.keys() == want.keys()
        for k in want:
            for a, b in zip(jax.tree.leaves(got[k]), jax.tree.leaves(want[k])):
                assert a.dtype == np.uint32 and np.array_equal(a, np.asarray(b)), k


def test_dist_ntt_roundtrip(world):
    p, cfg, mesh = setup()
    x = residues(np.random.default_rng(0), p, 2)              # [B=2, L, n]
    fwd, inv = make_dist_ntt(cfg, mesh)
    y = np.asarray(fwd(jnp.asarray(x)))
    got_y, got_x, _, _ = on_ranks(world, R.dist_ntt, *args(cfg), x)
    assert np.array_equal(got_y, y)
    assert np.array_equal(got_x, x)


def test_dist_ntt_pointwise_mul_is_ring_mul(world):
    p, cfg, mesh = setup()
    rng = np.random.default_rng(1)
    a = rng.integers(0, min(p.qs), p.n)
    b = rng.integers(0, min(p.qs), p.n)

    def stored(v):
        res = np.stack([v % q for q in p.qs]).astype(np.uint32)
        return np.stack([to_dist_layout(res, cfg)] * 2)       # pad batch to 2

    got = on_ranks(world, R.dist_pointwise, *args(cfg), stored(a), stored(b))
    fwd, inv = make_dist_ntt(cfg, mesh)
    jax_prod = np.asarray(inv(mulmod(fwd(jnp.asarray(stored(a))), fwd(jnp.asarray(stored(b))),
                                     p.qs)))
    assert np.array_equal(got, jax_prod)
    na = ntt_negacyclic(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    nb = ntt_negacyclic(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    want = np.asarray(intt_negacyclic(mulmod(na, nb, p.qs), p.n, p.qs))
    assert np.array_equal(from_dist_layout(got[0], cfg), want)


def test_dist_deep_chain_mul_relin_rescale(world):
    """Depth-3 mul+relin+rescale chain on the mesh at the full padded
    allocation [B, 2, L0, n]: every level equals the JAX package's mesh
    chain and the single-chip fast path; the last decrypts to the squaring
    chain."""
    from alchemy_tpu.examples.deep_circuit import expected_square_chain_mod2
    from alchemy_tpu.she.keys import gaussian_coeffs

    depth, L0 = 3, 6
    p = FastParams.make(7, L0, zp=2)
    cfg = DistConfig(p=p, n1=8, n2=p.n // 8)
    mesh = make_mesh(MESH)
    rng = np.random.default_rng(3)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return fast._ntt_p(pp, jnp.asarray(np.stack([s_int % q for q in pp.qs]).astype(np.uint32)))

    msg = rng.integers(0, 2, p.n)
    ct_f = fast.encrypt(p, key_at(p), msg, rng)
    fwd, inv = make_dist_ntt(cfg, mesh)

    def coeffs_of(ct, pp):
        return np.asarray(fast._intt_p(pp, ct))

    def to_dist_ntt(rows):
        stored = to_dist_layout(rows, cfg)
        flat = stored.reshape(-1, L0, p.n)
        out = np.asarray(fwd(jnp.asarray(np.concatenate([flat, flat]))))[: flat.shape[0]]
        return out.reshape(stored.shape)

    run_mul = make_dist_mul_relin(cfg, mesh)
    ct_d = np.stack([to_dist_ntt(coeffs_of(ct_f, p))] * 2)   # [B=2, 2, L0, n]
    cur_p, hints, jax_levels, ct_j = p, [], [], jnp.asarray(ct_d)
    for level in range(depth):
        act = len(cur_p.qs)
        hb, ha = fast.relin_hint(cur_p, key_at(cur_p), rng)
        ct_f = fast.rescale(cur_p, fast.mul_relin(cur_p, ct_f, ct_f, hb, ha), 1)
        pad = []
        for h in (hb, ha):
            rows = np.zeros((act, L0, p.n), dtype=np.uint32)
            rows[:, :act] = coeffs_of(h, cur_p)
            full = np.zeros((L0, L0, p.n), dtype=np.uint32)
            full[:act] = to_dist_ntt(rows)
            pad.append(full)
        hints.append(tuple(pad))
        ct_j = make_dist_rescale(cfg, mesh, act)(run_mul(ct_j, ct_j, *map(jnp.asarray, pad)))
        jax_levels.append(np.asarray(ct_j))
        cur_p = FastParams(n=p.n, qs=cur_p.qs[:-1], zp=p.zp, impl=p.impl)
        got = from_dist_layout(np.asarray(inv(ct_j.reshape(4, L0, p.n))), cfg).reshape(2, 2, L0, p.n)
        assert np.array_equal(got[0][:, :act - 1], coeffs_of(ct_f, cur_p)), f"level {level}"
        assert not got[0][:, act - 1:].any()

    port_levels = on_ranks(world, R.dist_chain, *args(cfg), ct_d, hints)
    for level, (a, b) in enumerate(zip(port_levels, jax_levels)):
        assert np.array_equal(a, b), f"level {level}"
    assert np.array_equal(fast.decrypt(cur_p, key_at(cur_p), ct_f),
                          expected_square_chain_mod2(msg, p.n, depth))


def test_dist_mul_relin_matches_single_chip(world):
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(2)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct1 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    ct2 = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    want_coeff = np.asarray(intt_negacyclic(fast.mul_relin(p, ct1, ct2, hb, ha), p.n, p.qs))
    fwd, inv = make_dist_ntt(cfg, mesh)

    def bridge(x):
        stored = to_dist_layout(np.asarray(intt_negacyclic(x, p.n, p.qs)), cfg)
        return np.asarray(fwd(jnp.asarray(np.stack([stored, stored]))))[0]

    d1 = np.stack([bridge(ct1[0]), bridge(ct1[1])])
    d2 = np.stack([bridge(ct2[0]), bridge(ct2[1])])
    batch1, batch2 = np.stack([d1, d1]), np.stack([d2, d2])   # [B=2, 2, L, n]
    d_hb = np.stack([bridge(hb[i]) for i in range(len(p.qs))])
    d_ha = np.stack([bridge(ha[i]) for i in range(len(p.qs))])
    want = np.asarray(make_dist_mul_relin(cfg, mesh)(*map(jnp.asarray, (batch1, batch2, d_hb, d_ha))))
    got = on_ranks(world, R.dist_mul_relin, *args(cfg), batch1, batch2, d_hb, d_ha)
    assert np.array_equal(got, want)
    for c in range(2):
        two = jnp.asarray(np.stack([got[0, c]] * 2))
        assert np.array_equal(from_dist_layout(np.asarray(inv(two))[0], cfg), want_coeff[c])


def test_ring_strategy_matches_a2a(world):
    """The staged-ring transpose is bit-identical to the all_to_all
    strategy for the NTT and the fused mul+relin, in both packages."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(7)
    x = residues(rng, p, 2)
    fwd_a, _ = make_dist_ntt(cfg, mesh, strategy="a2a")
    want = np.asarray(fwd_a(jnp.asarray(x)))
    ring_y, ring_x, _, _ = on_ranks(world, R.dist_ntt, *args(cfg), x, "ring")
    assert np.array_equal(ring_y, want) and np.array_equal(ring_x, x)

    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    d = np.stack([np.asarray(ct)] * 2).astype(np.uint32)
    h = [np.stack([np.asarray(x[i]) for i in range(len(p.qs))]) for x in (hb, ha)]
    out_a = np.asarray(make_dist_mul_relin(cfg, mesh, strategy="a2a")(
        *map(jnp.asarray, (d, d, *h))))
    for strategy in ("a2a", "ring"):
        got = on_ranks(world, R.dist_mul_relin, *args(cfg), d, d, *h, strategy)
        assert np.array_equal(got, out_a), strategy


def test_pick_dist_strategy_single_process(world):
    assert world.run(R.strategy_of, MESH) == ["a2a"] * 8


def test_dist_ntt_communication_pattern(world):
    """The a2a forward NTT makes exactly one all_to_all on 'coeff' and no
    other collective; the ring makes C-1 point-to-point rounds and no
    all_to_all (counted by the port's comm helpers on every rank)."""
    p, cfg, _ = setup(log_n=8, nlimb=4)
    C = MESH[2]
    x = residues(np.random.default_rng(0), p, 2)
    _, _, calls, inv_calls = on_ranks(world, R.dist_ntt, *args(cfg), x, "a2a")
    assert calls == {("all_to_all", "coeff"): 1} and inv_calls == calls
    _, _, calls, inv_calls = on_ranks(world, R.dist_ntt, *args(cfg), x, "ring")
    assert calls == {("p2p", "coeff"): C - 1} and inv_calls == calls


def test_dist_mul_relin_large_batch_dp(world):
    """A ciphertext batch LARGER than the mesh (B=16 on 2 batch shards):
    every row equals the JAX package's mesh result and the single-chip fast
    path."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    B = 16
    rng = np.random.default_rng(9)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    cts = [fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(B)]
    fwd, inv = make_dist_ntt(cfg, mesh)

    def bridge_rows(rows):
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, p.qs))
        return np.asarray(fwd(jnp.asarray(to_dist_layout(coeff, cfg))))

    L = len(p.qs)
    d_cts = bridge_rows(np.stack([np.asarray(c) for c in cts]).reshape(2 * B, L, p.n)).reshape(
        B, 2, L, p.n)
    d_hb = bridge_rows(np.stack([np.asarray(hb[i]) for i in range(L)]))
    d_ha = bridge_rows(np.stack([np.asarray(ha[i]) for i in range(L)]))
    other = np.roll(d_cts, -1, axis=0)
    want = np.asarray(make_dist_mul_relin(cfg, mesh)(*map(jnp.asarray, (d_cts, other, d_hb, d_ha))))
    got = on_ranks(world, R.dist_mul_relin, *args(cfg), d_cts, other, d_hb, d_ha)
    assert np.array_equal(got, want)
    coeff = from_dist_layout(np.asarray(inv(jnp.asarray(got.reshape(2 * B, L, p.n)))), cfg)
    coeff = coeff.reshape(B, 2, L, p.n)
    for i in range(B):
        want_i = fast.mul_relin(p, cts[i], cts[(i + 1) % B], hb, ha)
        assert np.array_equal(coeff[i], np.asarray(intt_negacyclic(want_i, p.n, p.qs))), f"row {i}"


def test_row_hint_placement_matches_digit(world):
    """Gadget-row hint sharding (one int64 all_reduce over 'limb') is
    bit-identical to the digit placement and to the JAX package's row
    placement."""
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(13)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    d = np.stack([np.asarray(ct)] * 2).astype(np.uint32)
    h = [np.stack([np.asarray(x[i]) for i in range(len(p.qs))]) for x in (hb, ha)]
    want = np.asarray(make_dist_mul_relin(cfg, mesh, hint_placement="row")(
        *map(jnp.asarray, (d, d, *h))))
    got_r = on_ranks(world, R.dist_mul_relin, *args(cfg), d, d, *h, None, "row")
    got_d = on_ranks(world, R.dist_mul_relin, *args(cfg), d, d, *h)
    assert np.array_equal(got_r, want) and np.array_equal(got_d, want)


def test_dist_mul_relin_hybrid_matches_single(world):
    """Hybrid KS on the mesh, L=12 → dnum=3, α=4, K=4, T=16: the port's
    ranks equal the JAX package's mesh result, which equals
    she/hybrid.mul_relin_hybrid on every batch row."""
    from alchemy_tpu.she.hybrid import HybridKS, hybrid_keygen_hint, mul_relin_hybrid

    L, n1 = 12, 8
    p = FastParams.make(7, L, zp=2)
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
    mesh = make_mesh(MESH)
    hk = HybridKS.make(p)
    assert len(hk.pe.qs) == 16 and len(hk.groups) == 3
    rng = np.random.default_rng(21)
    s, (hb, ha) = hybrid_keygen_hint(hk, rng)
    cts_a = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng) for _ in range(2)]
    cts_b = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng) for _ in range(2)]
    wants = [np.asarray(intt_negacyclic(mul_relin_hybrid(hk, a, b, hb, ha), p.n, p.qs))
             for a, b in zip(cts_a, cts_b)]
    fwd_b, inv_b = make_dist_ntt(cfg, mesh)
    fwd_e, _ = make_dist_ntt(DistConfig(p=hk.pe, n1=n1, n2=p.n // n1), mesh)

    def bridge(rows, qs, fwd):
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, qs))
        return np.asarray(fwd(jnp.asarray(to_dist_layout(coeff, cfg))))

    d_a = bridge(np.stack([np.asarray(c) for c in cts_a]).reshape(4, L, p.n), p.qs, fwd_b)
    d_b = bridge(np.stack([np.asarray(c) for c in cts_b]).reshape(4, L, p.n), p.qs, fwd_b)
    d_a, d_b = d_a.reshape(2, 2, L, p.n), d_b.reshape(2, 2, L, p.n)

    def bridge_hint(rows):
        h4 = np.concatenate([np.asarray(rows), np.zeros_like(np.asarray(rows[:1]))])
        return bridge(h4, hk.pe.qs, fwd_e)[:3]

    d_hb, d_ha = bridge_hint(hb), bridge_hint(ha)
    want = np.asarray(make_dist_mul_relin_hybrid(hk, cfg, mesh)(
        *map(jnp.asarray, (d_a, d_b, d_hb, d_ha))))
    got = on_ranks(world, R.dist_hybrid, *args(cfg), len(hk.ps), d_a, d_b, d_hb, d_ha)
    assert np.array_equal(got, want)
    coeff = from_dist_layout(np.asarray(inv_b(jnp.asarray(got.reshape(4, L, p.n)))), cfg)
    for i in range(2):
        assert np.array_equal(coeff.reshape(2, 2, L, p.n)[i], wants[i].reshape(2, L, p.n))


def test_dist_ntt_overlapped_transpose_bit_identical(world, monkeypatch):
    """ALCHEMY_DIST_OVERLAP=2 splits each transpose into 2
    destination-aligned all_to_alls: forward and inverse equal the one-shot
    transpose and the JAX package's chunked run."""
    p, cfg, mesh = setup(log_n=8, nlimb=4)
    x = residues(np.random.default_rng(4), p, 2)
    monkeypatch.setenv("ALCHEMY_DIST_OVERLAP", "2")
    fwd2, inv2 = make_dist_ntt(cfg, mesh)
    y2 = np.asarray(fwd2(jnp.asarray(x)))
    got_y, got_x, calls, inv_calls = on_ranks(world, R.dist_ntt, *args(cfg), x, None, 2)
    assert np.array_equal(got_y, y2) and np.array_equal(got_x, x)
    assert calls == {("all_to_all", "coeff"): 2} and inv_calls == calls
    one_y, _, one_calls, _ = on_ranks(world, R.dist_ntt, *args(cfg), x)
    assert np.array_equal(one_y, got_y) and one_calls == {("all_to_all", "coeff"): 1}


def test_dryrun_multichip(world):
    """The port's `dryrun_multichip(8)` runs on the 8 ranks and its three
    outputs equal the JAX package's dry-run steps (`__graft_entry__.py:36`)
    from the same seed in the port's default slot order."""
    from alchemy_tpu.parallel.mesh import pick_mesh_shape
    from alchemy_tpu.she.hybrid import HybridKS, hybrid_keygen_hint, pick_dnum

    got = on_ranks(world, R.dryrun, 8)
    batch, limb, coeff = pick_mesh_shape(8)
    mesh = make_mesh((batch, limb, coeff))
    nlimb = 2 * limb
    p = FastParams.make(6, nlimb, zp=2, impl="mxu")
    n1 = coeff * 4
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
    rng = np.random.default_rng(0)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    cts = jnp.asarray(np.stack([np.asarray(fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng))
                                for _ in range(batch * 2)]))
    out = make_dist_mul_relin(cfg, mesh)(cts, cts, jnp.asarray(hb), jnp.asarray(ha))
    out2 = make_dist_rescale(cfg, mesh, active=nlimb)(out)
    alpha = -(-nlimb // pick_dnum(nlimb))
    hk = HybridKS.make(p, k_sp=-(-alpha // limb) * limb)
    _, (hhb, hha) = hybrid_keygen_hint(hk, rng)
    outh = make_dist_mul_relin_hybrid(hk, cfg, mesh)(cts, cts, jnp.asarray(hhb), jnp.asarray(hha))
    for a, b in zip(got, (out, out2, outh)):
        assert a.shape == (batch * 2, 2, nlimb, p.n) and np.array_equal(a, np.asarray(b))


def test_entry_points_refuse_the_card_without_one():
    """The mesh, the world and every make_dist_* default to the card and
    raise without one; an unknown backend or device type raises."""
    import torch

    from alchemy_tpu_torch.parallel.mesh import make_mesh as tmake_mesh
    from alchemy_tpu_torch.parallel.multihost import init_multihost

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake_mesh((1, 1, 1))
    with pytest.raises(RuntimeError, match="nccl"):
        init_multihost()
    with pytest.raises(ValueError, match="backend"):
        init_multihost(backend="mpi")
    with pytest.raises(ValueError, match="device_type"):
        tmake_mesh((1, 1, 1), device_type="tpu")

    class CardMesh:
        """A one-rank ('batch', 'limb', 'coeff') mesh that says "cuda"."""
        device_type, mesh_dim_names = "cuda", ("batch", "limb", "coeff")

        def size(self, dim=None):
            return 1

        def get_local_rank(self, dim=None):
            return 0

    p, cfg, _ = setup(6, 2, 8)
    tcfg = R._cfg(p.n, p.qs, p.impl, 8)
    from alchemy_tpu_torch.parallel.pipeline import make_pipeline_chain

    for make in (lambda m: tdist.make_dist_ntt(tcfg, m),
                 lambda m: tdist.make_dist_mul_relin(tcfg, m),
                 lambda m: tdist.make_dist_rescale(tcfg, m, 2),
                 lambda m: make_pipeline_chain(tcfg.p, m, [], 1, 1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(CardMesh())


@pytest.mark.cuda
def test_dist_mul_relin_on_the_card_matches_jax():
    """One NCCL rank on the card, mesh (1, 1, 1): make_dist_mul_relin with
    both hint placements equals the JAX package's mesh result."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p, cfg, mesh = setup(log_n=7, nlimb=4)
    rng = np.random.default_rng(13)
    s = fast.keygen(p, rng)
    hb, ha = fast.relin_hint(p, s, rng)
    ct = fast.encrypt(p, s, rng.integers(0, 2, p.n), rng)
    d = np.stack([np.asarray(ct)] * 2).astype(np.uint32)
    h = [np.stack([np.asarray(x[i]) for i in range(len(p.qs))]) for x in (hb, ha)]
    want = np.asarray(make_dist_mul_relin(cfg, mesh)(*map(jnp.asarray, (d, d, *h))))
    one = ((1, 1, 1), *args(cfg)[1:])
    with LocalWorld(1, backend="nccl", timeout=CALL_S) as w:
        for placement in ("digit", "row"):
            got = w.run(R.dist_mul_relin, *one, d, d, *h, None, placement, "cuda")[0]
            assert np.array_equal(got, want), placement
