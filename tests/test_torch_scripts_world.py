"""alchemy_tpu_torch.scripts across rank processes, on two gloo ranks on the
CPU (one `LocalWorld` for the module) at n = 2^10: `bench_strategy`,
`bench_comm_fit` and `bench_pipeline` give records with the JAX scripts'
keys plus `backend` and `card`, the pipelined chain is bit-identical to the
sequential one, and each writes only its `--out` path: the JAX scripts'
records at the root of the repository stay byte for byte as they were."""

import hashlib
import json
from pathlib import Path

import pytest

from alchemy_tpu_torch import bench
from alchemy_tpu_torch.parallel.multihost import LocalWorld
from alchemy_tpu_torch.scripts import bench_comm_fit, bench_pipeline, bench_strategy

ROOT = Path(__file__).resolve().parents[1]
ROOT_RECORDS = ("STRATEGY_r04.json", "COMM_FIT_r05.json", "PIPELINE_r05.json")


@pytest.fixture(scope="module")
def world():
    with LocalWorld(2, backend="gloo", timeout=300) as w:
        yield w


@pytest.fixture(autouse=True)
def guard(monkeypatch, tmp_path):
    """The default record directory moved under tmp_path (it must stay
    empty: every run here passes --out), and the root's records hashed
    before and after."""
    monkeypatch.setattr(bench, "OUT_DIR", tmp_path / "build_bench")
    before = {f: hashlib.sha256((ROOT / f).read_bytes()).hexdigest() for f in ROOT_RECORDS}
    yield
    assert not (tmp_path / "build_bench").exists()
    assert before == {f: hashlib.sha256((ROOT / f).read_bytes()).hexdigest()
                      for f in ROOT_RECORDS}


def _main(module, world, tmp_path, capsys) -> dict:
    path = tmp_path / "rec.json"
    assert module.main(["--device", "cpu", "--out", str(path)], world=world) == 0
    rec = json.loads(capsys.readouterr().out)
    assert json.loads(path.read_text()) == rec
    assert rec["backend"] == "torch-cpu" and rec["card"] is None
    return rec


def test_bench_strategy(monkeypatch, world, tmp_path, capsys):
    monkeypatch.setattr(bench_strategy, "SIZES", ((10, 4, 3),))
    rec = _main(bench_strategy, world, tmp_path, capsys)
    assert set(rec) == {"setup", "results_ms_per_call", "ring_over_a2a_n2e10", "backend", "card"}
    assert set(rec["results_ms_per_call"]) == {"n2e10_L4_a2a_ms", "n2e10_L4_ring_ms"}
    assert rec["ring_over_a2a_n2e10"] > 0


def test_bench_comm_fit(monkeypatch, world, tmp_path, capsys):
    monkeypatch.setattr(bench_comm_fit, "ROW_COUNTS", (8, 32, 128))
    rec = _main(bench_comm_fit, world, tmp_path, capsys)
    assert set(rec) == {"setup", "points", "affine_fit", "interpretation", "backend", "card"}
    assert [p["rows"] for p in rec["points"]] == [8, 32, 128]
    assert set(rec["points"][0]) == {"rows", "bytes_crossing_per_device", "us_per_call", "iters"}
    assert set(rec["affine_fit"]) == {"model", "BW_MBps", "lat_us", "max_relative_residual",
                                      "mean_relative_residual"}


def test_bench_pipeline(monkeypatch, world, tmp_path, capsys):
    for k, v in {"PIPE_DEPTH": "4", "PIPE_STAGES": "2", "PIPE_MICRO": "4",
                 "PIPE_LOG_N": "10"}.items():
        monkeypatch.setenv(k, v)
    rec = _main(bench_pipeline, world, tmp_path, capsys)
    assert set(rec) == {"config", "bit_identical_to_sequential", "measured",
                        "utilization_accounting", "memory_residency", "backend", "card"}
    assert rec["bit_identical_to_sequential"]
    assert rec["utilization_accounting"]["bubble_fraction"] == round(1 / 5, 4)
    mem = rec["memory_residency"]
    assert mem["per_device_argument_bytes"] * 2 == mem["replicated_would_be_bytes"]
    assert {"pipelined_ms_per_call", "sequential_ms_per_call", "ratio_pipe_over_seq",
            "note"} <= set(rec["measured"])
