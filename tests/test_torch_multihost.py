"""alchemy_tpu_torch.parallel across two OS processes (gloo on the CPU): the
port's counterparts of tests/test_multihost.py. The 'coeff' axis, then the
'limb' axis, spans the process boundary; the results equal the JAX
package's (its single-device references and its mesh ops, computed in the
pytest process). The whole-program half of
`test_two_process_whole_program_and_hybrid` (jit_compile over a mesh) has
no port counterpart yet: the port's jit_compile takes no mesh."""

import numpy as np
import pytest

import jax.numpy as jnp

import torch_rank_cases as R
from alchemy_tpu.backend.ntt import intt_negacyclic, ntt_negacyclic
from alchemy_tpu.backend.xla import mulmod
from alchemy_tpu.parallel.dist import DistConfig, make_dist_ntt
from alchemy_tpu.parallel.mesh import make_mesh
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams
from alchemy_tpu_torch.parallel.multihost import LocalWorld

CALL_S = 240


@pytest.fixture(scope="module")
def world():
    with LocalWorld(2, backend="gloo", timeout=CALL_S) as w:
        yield w


def layout(cfg):
    """(to storage order, from storage order) index maps of the dist layout."""
    n1, n2 = cfg.n1, cfg.n2
    j2, j1 = np.divmod(np.arange(cfg.p.n), n1)
    to = j1 * n2 + j2
    back = np.empty_like(to)
    back[to] = np.arange(cfg.p.n)
    return to, back


def test_two_process_dist_ntt(world):
    """multihost_worker.py in the port: the NTT round trip and the sharded
    ring product with 'coeff' across the two processes, then the fused
    mul+relin with 'limb' across them, against the single-device fast
    path."""
    B, nproc = 2, 2
    p = FastParams.make(6, 2, zp=2)
    cfg = DistConfig(p=p, n1=8, n2=p.n // 8)
    to, back = layout(cfg)
    rng = np.random.default_rng(0)
    a = rng.integers(0, min(p.qs), p.n)
    b = rng.integers(0, min(p.qs), p.n)

    def host_stack(v):
        return np.stack([np.stack([v % q for q in p.qs]).astype(np.uint32)[..., to]] * B)

    coeff_mesh = ((1, 1, nproc), p.n, p.qs, p.impl, cfg.n1)
    _, rt, _, _ = world.run(R.dist_ntt, *coeff_mesh, host_stack(a))[0]
    assert np.array_equal(rt, host_stack(a))
    prod = world.run(R.dist_pointwise, *coeff_mesh, host_stack(a), host_stack(b))[0]
    na = ntt_negacyclic(jnp.asarray(np.stack([a % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    nb = ntt_negacyclic(jnp.asarray(np.stack([b % q for q in p.qs]).astype(np.uint32)), p.n, p.qs)
    ref = np.asarray(intt_negacyclic(mulmod(na, nb, p.qs), p.n, p.qs))
    assert np.array_equal(prod, np.stack([ref[..., to]] * B))

    s_key = fast.keygen(p, np.random.default_rng(1))
    hbf, haf = fast.relin_hint(p, s_key, np.random.default_rng(2))
    ct1 = fast.encrypt(p, s_key, rng.integers(0, 2, p.n), np.random.default_rng(3))
    ct2 = fast.encrypt(p, s_key, rng.integers(0, 2, p.n), np.random.default_rng(4))
    want_coeff = np.asarray(intt_negacyclic(fast.mul_relin(p, ct1, ct2, hbf, haf), p.n, p.qs))
    fwd, inv = make_dist_ntt(cfg, make_mesh((1, nproc, 1)))

    def bridge_rows(rows):
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, p.qs))
        return np.asarray(fwd(jnp.asarray(coeff[..., to])))

    L = len(p.qs)
    d_cts = bridge_rows(np.concatenate([np.asarray(ct1), np.asarray(ct2)])).reshape(2, 2, L, p.n)
    d_hb = bridge_rows(np.stack([np.asarray(hbf[i]) for i in range(L)]))
    d_ha = bridge_rows(np.stack([np.asarray(haf[i]) for i in range(L)]))
    out = world.run(R.dist_mul_relin, (1, nproc, 1), p.n, p.qs, p.impl, cfg.n1,
                    np.stack([d_cts[0]] * B), np.stack([d_cts[1]] * B), d_hb, d_ha)[0]
    got = np.asarray(inv(jnp.asarray(out.reshape(2 * B, L, p.n))))[..., back]
    for bi in range(B):
        assert np.array_equal(got.reshape(B, 2, L, p.n)[bi], want_coeff)


def test_two_process_hybrid(world):
    """The hybrid half of multihost_worker2.py: make_dist_mul_relin_hybrid
    at L = 12 with 'coeff' across the two processes, against
    she/hybrid.mul_relin_hybrid."""
    from alchemy_tpu.she.hybrid import HybridKS, hybrid_keygen_hint, mul_relin_hybrid

    L, n1, nproc = 12, 8, 2
    p = FastParams.make(7, L, zp=2)
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
    to, back = layout(cfg)
    hk = HybridKS.make(p)
    rng = np.random.default_rng(21)
    s, (hb, ha) = hybrid_keygen_hint(hk, rng)
    cts_a = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng) for _ in range(2)]
    cts_b = [fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng) for _ in range(2)]
    wants = [np.asarray(intt_negacyclic(mul_relin_hybrid(hk, a, b, hb, ha), p.n, p.qs))
             for a, b in zip(cts_a, cts_b)]
    mesh = make_mesh((1, 1, nproc))
    fwd_b, inv_b = make_dist_ntt(cfg, mesh)
    fwd_e, _ = make_dist_ntt(DistConfig(p=hk.pe, n1=n1, n2=p.n // n1), mesh)

    def bridge(rows, qs, fwd):
        coeff = np.asarray(intt_negacyclic(jnp.asarray(rows), p.n, qs))
        return np.asarray(fwd(jnp.asarray(coeff[..., to])))

    d_a = bridge(np.stack([np.asarray(c) for c in cts_a]).reshape(4, L, p.n), p.qs, fwd_b)
    d_b = bridge(np.stack([np.asarray(c) for c in cts_b]).reshape(4, L, p.n), p.qs, fwd_b)

    def bridge_hint(rows):
        h4 = np.concatenate([np.asarray(rows), np.zeros_like(np.asarray(rows[:1]))])
        return bridge(h4, hk.pe.qs, fwd_e)[:3]

    out = world.run(R.dist_hybrid, (1, 1, nproc), p.n, p.qs, p.impl, n1, len(hk.ps),
                    d_a.reshape(2, 2, L, p.n), d_b.reshape(2, 2, L, p.n),
                    bridge_hint(hb), bridge_hint(ha))[0]
    got = np.asarray(inv_b(jnp.asarray(out.reshape(4, L, p.n))))[..., back].reshape(2, 2, L, p.n)
    for i in range(2):
        assert np.array_equal(got[i], wants[i].reshape(2, L, p.n)), f"row {i}"


@pytest.mark.cuda
def test_two_ranks_share_the_card_over_gloo():
    """Two gloo ranks on one card, 'coeff' across them: the dist NTT round
    trip on CUDA tensors, staged through host memory by the comm helpers."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = FastParams.make(6, 2, zp=2)
    x = np.stack([np.stack([np.arange(p.n) % q for q in p.qs]).astype(np.uint32)] * 2)
    with LocalWorld(2, backend="gloo", timeout=CALL_S) as w:
        rt, staged = w.run(R.dist_ntt_on_card, (1, 1, 2), p.n, p.qs, p.impl, 8, x)[0]
    assert np.array_equal(rt, x) and staged > 0
