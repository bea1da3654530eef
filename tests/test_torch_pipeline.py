"""alchemy_tpu_torch.parallel.pipeline on gloo ranks on the CPU: one case per
test of tests/test_pipeline.py. The hints, ciphertexts and the JAX
package's pipelined result come from the pytest process (its CPU mesh,
tests/conftest.py); the port's pipeline runs on one world of 4 processes
serving every case (S = 2 as a (2, 2) mesh of replicas × stages, S = 4 as
a 1-D mesh); results must be equal (tolerance 0)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

import torch_rank_cases as R
from alchemy_tpu.parallel.pipeline import _level_consts, make_pipeline_chain, rescale_padded
from alchemy_tpu.she import fast
from alchemy_tpu.she.fast import FastParams
from alchemy_tpu.she.keys import gaussian_coeffs
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.parallel import pipeline as tpipe
from alchemy_tpu_torch.parallel.multihost import LocalWorld
from alchemy_tpu_torch.she.fast import FastParams as TFastParams

WORLD = 4
CALL_S = 240


@pytest.fixture(scope="module")
def world():
    with LocalWorld(WORLD, backend="gloo", timeout=CALL_S) as w:
        yield w


def chain_inputs(depth, L0, seed, n_cts):
    """Per-level hints at the level's active chain, zero-padded to
    [L0, L0, n] (as tests/test_pipeline.py makes them), the sequential
    reference's (params, hb, ha) and n_cts fresh ciphertexts."""
    p = FastParams.make(7, L0, zp=2)
    rng = np.random.default_rng(seed)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return fast._ntt_p(pp, jnp.asarray(np.stack([s_int % q for q in pp.qs]).astype(np.uint32)))

    hints, ref_hints = [], []
    cur_p = p
    for lvl in range(depth):
        act = L0 - lvl
        hb, ha = fast.relin_hint(cur_p, key_at(cur_p), rng)
        pb = np.zeros((L0, L0, p.n), dtype=np.uint32)
        pa = np.zeros((L0, L0, p.n), dtype=np.uint32)
        pb[:act, :act] = np.asarray(hb)
        pa[:act, :act] = np.asarray(ha)
        hints.append((pb, pa))
        ref_hints.append((cur_p, hb, ha))
        cur_p = FastParams(n=p.n, qs=cur_p.qs[:-1], zp=p.zp, impl=p.impl)
    cts = [fast.encrypt(p, key_at(p), rng.integers(0, 2, p.n), rng) for _ in range(n_cts)]
    return p, hints, ref_hints, np.stack([np.asarray(c) for c in cts])


def on_ranks(world, S, p, hints, mb, M, batch):
    shape, names = ((WORLD // S, S), ("replica", "stage")) if S < WORLD else ((S,), ("stage",))
    return world.run(R.pipeline, shape, names, p.n, p.qs, p.impl, hints, mb, M, batch)[0]


def jax_pipeline(p, S, hints, mb, M, batch):
    mesh = Mesh(np.array(jax.devices()[:S]), ("stage",))
    return np.asarray(make_pipeline_chain(p, mesh, hints, mb=mb, n_micro=M)(jnp.asarray(batch)))


def test_pipeline_chain_matches_sequential(world):
    depth, S, mb, M, L0 = 4, 2, 1, 4, 6
    p, hints, ref_hints, batch = chain_inputs(depth, L0, 5, M * mb)
    got, ranks = on_ranks(world, S, p, hints, mb, M, batch)
    assert np.array_equal(got, jax_pipeline(p, S, hints, mb, M, batch))
    act_final = L0 - depth
    for i in range(M * mb):
        cur = jnp.asarray(batch[i])
        for (pp, hb, ha) in ref_hints:
            cur = fast.rescale(pp, fast.mul_relin(pp, cur, cur, hb, ha), 1)
        assert np.array_equal(got[i][:, :act_final], np.asarray(cur)), f"ct {i}"
        assert not got[i][:, act_final:].any()
    # one injection all_reduce per tick that carries a micro-batch, one hop per tick
    assert ranks[0]["calls"] == {("all_reduce", "stage"): M, ("p2p", "stage"): S + M - 1}


def test_pipeline_depth_not_divisible_by_stages(world):
    """Depth 3 on 2 stages: the pad slot is disabled and the result equals
    the JAX package's pipeline and its sequential padded chain; the port's
    `rescale_padded` equals the JAX one level by level."""
    depth, S, mb, M, L0 = 3, 2, 1, 4, 5
    p, hints, _, batch = chain_inputs(depth, L0, 6, M * mb)
    got, _ = on_ranks(world, S, p, hints, mb, M, batch)
    assert np.array_equal(got, jax_pipeline(p, S, hints, mb, M, batch))
    tp = TFastParams(n=p.n, qs=p.qs, zp=p.zp, impl=p.impl)
    for i in range(M * mb):
        cur = jnp.asarray(batch[i])
        for lvl in range(depth):
            pb, pa = hints[lvl]
            full = fast._mul_relin_jnp(p, cur, cur, jnp.asarray(pb), jnp.asarray(pa))
            c = _level_consts(p, lvl)
            cur = rescale_padded(p, full, {k: jnp.asarray(v) for k, v in c.items()})
            mine = tpipe.rescale_padded(tp, to_torch(np.asarray(full), "cpu"),
                                        tpipe._level_consts(tp, lvl))
            assert np.array_equal(to_numpy(mine), np.asarray(cur)), f"ct {i} level {lvl}"
        assert np.array_equal(got[i], np.asarray(cur)), f"ct {i}"


def test_pipeline_memory_residency(world):
    """Each stage's device holds its own levels' hints and its own
    micro-batches: per rank, hint bytes are total/S and input bytes
    total/S (a replicated layout would hold the totals); the result equals
    the JAX package's."""
    depth, S, mb, M, L0 = 4, 4, 1, 4, 6
    p, hints, _, batch = chain_inputs(depth, L0, 6, M * mb)
    got, ranks = on_ranks(world, S, p, hints, mb, M, batch)
    assert np.array_equal(got, jax_pipeline(p, S, hints, mb, M, batch))
    hint_total = 2 * depth * L0 * L0 * p.n * 4          # hb+ha, all levels
    input_total = M * mb * 2 * L0 * p.n * 4
    for r in ranks:
        assert r["hint_bytes"] == hint_total // S
        assert r["input_bytes"] == input_total // S


@pytest.mark.cuda
def test_pipeline_on_the_card_matches_jax():
    """One NCCL rank on the card (S = 1): the port's pipeline, kernels A, B
    and the standalone transforms, equals the JAX package's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    depth, mb, M, L0 = 3, 1, 2, 5
    p, hints, _, batch = chain_inputs(depth, L0, 7, M * mb)
    with LocalWorld(1, backend="nccl", timeout=CALL_S) as w:
        got = w.run(R.pipeline_on_card, p.n, p.qs, p.impl, hints, mb, M, batch)[0]
    assert np.array_equal(got, jax_pipeline(p, 1, hints, mb, M, batch))
