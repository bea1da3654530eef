"""alchemy_tpu_torch.parallel.bench_scaling against the JAX package's
harness: `predict_*` equal the JAX functions on a grid of arguments (pure
arithmetic, exact), and `sweep` runs at log_n 8 on a world of two gloo ranks
on the CPU, returning the JAX sweep's keys at every level (the JAX keys from
its own `sweep` with its measurements stubbed). A user's
ALCHEMY_DIST_OVERLAP survives the sweep (the JAX harness deletes it,
bench_scaling.py:250), an unset one stays unset, and DIST_STRATEGIES is as
it was."""

import itertools

import pytest

import torch_rank_cases as R
from alchemy_tpu.parallel import bench_scaling as jbs
from alchemy_tpu_torch.parallel import bench_scaling as tbs
from alchemy_tpu_torch.parallel.multihost import LocalWorld

ANCHORS = {"t1_us": {15: 46.5, 16: 93.25}, "t1_op_us": 28.0}


@pytest.mark.parametrize("log_n,nlimb,C,batch", itertools.product(
    (12, 15, 16), (4, 8), (2, 4, 8), (1, 4)))
def test_predict_ici_matches_jax(log_n, nlimb, C, batch):
    for t1, bw, lat in ((46.0, 50.0, 1.0), (13.7, 200.0, 0.5)):
        assert (tbs.predict_ici_efficiency(log_n, nlimb, C, batch, t1, bw, lat)
                == jbs.predict_ici_efficiency(log_n, nlimb, C, batch, t1, bw, lat))


@pytest.mark.parametrize("C,LS", [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (2, 2), (1, 2)])
def test_predict_full_op_matches_jax(C, LS):
    for log_n, L, b, t1, bw, frac in itertools.product(
            (15, 16), (8, 16), (1, 4, 16), (28.0, 223.7), (50.0, 450.0), (0.84, 0.5)):
        assert (tbs.predict_full_op_efficiency(log_n, L, C, LS, b, t1, bw,
                                               digit_mac_fraction=frac)
                == jbs.predict_full_op_efficiency(log_n, L, C, LS, b, t1, bw,
                                                  digit_mac_fraction=frac))


def _keys(x):
    """The nested key structure of a sweep (dicts, and the first point of
    each list)."""
    if isinstance(x, dict):
        return {k: _keys(v) for k, v in x.items()}
    if isinstance(x, list) and x and isinstance(x[0], dict):
        return [_keys(x[0])]
    return None


@pytest.fixture(scope="module")
def jax_keys():
    """The JAX sweep's key structure, its measurements stubbed (no compile)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jbs, "measure_dist_ntt", lambda *a, **k: (1e-4, (1, 1, 2)))
    mp.setattr(jbs, "measure_comm_split", lambda *a, **k: (1e-4, 5e-5))
    try:
        return _keys(jbs.sweep(log_n=8, iters=1))
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def world():
    with LocalWorld(2, backend="gloo", timeout=240) as w:
        yield w


@pytest.mark.parametrize("overlap", ["4", None])
def test_sweep_on_two_ranks(world, jax_keys, overlap):
    out, after, before_keys, after_keys = world.run(R.scaling_sweep, 8, 2, ANCHORS, overlap)[0]
    got = _keys(out)
    # the JAX sweep names its anchor source in its model text; the port adds
    # "anchors_from" and the measured t1s beside the same keys
    for pred in ("ici_prediction", "full_op_prediction"):
        assert set(got[pred]) - set(jax_keys[pred]) <= {"anchors_from", "t1_us"}
        got[pred] = {k: v for k, v in got[pred].items() if k in jax_keys[pred]}
    assert got == jax_keys
    assert out["devices"] == 2 and [p["coeff_shards"] for p in out["points"]] == [1, 2, 2]
    assert [p["coeff_shards"] for p in out["comm_split"]] == [2]
    assert all(p["us_per_call"] > 0 for p in out["points"] + out["weak_scaling"])
    assert out["full_op_prediction"]["t1_op_us"] == ANCHORS["t1_op_us"]
    assert after == (overlap or "unset")
    assert before_keys == after_keys == ["a2a", "ring"]
