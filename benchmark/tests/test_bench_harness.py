"""The harness: every cell's files resolve and agree with BENCHMARK.json; a
whole run on the CPU at a tiny size is correct and reports what its traffic
names; the per-layer readers and the trace summary on known inputs; the
command's refusals."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import inputs, run as bench_run, trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = sorted(p.stem for p in (ROOT / "benchmark" / "workloads").glob("*.json"))
CONFIG_KEYS = {"name", "source", "system", "n", "qs", "zp", "order", "key_switching",
               "shoup_hints", "variance", "guarantees", "limits", "assumed", "reduced"}


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_resolve(name):
    cell, cfg, traffic = bench_run.load_cell(name)
    assert cfg["name"] == cell["config"]
    assert CONFIG_KEYS <= set(cfg)
    assert cfg["reduced"] == []
    assert set(cfg["limits"]) == {"mismatch", "bad_slots"}
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert (entry["config"], entry["traffic"], entry["chips"], entry["why"]) == (
        cell["config"], cell["traffic"], cell["chips"], cell["why"])
    conf = next(c for c in BENCH["configs"] if c["name"] == cfg["name"])
    assert conf["file"] == f"benchmark/configs/{cfg['name']}.json"
    assert conf["source"] == cfg["source"] and conf["reduced"] == cfg["reduced"]
    # the pool holds at least four times the card's 50 MB L2
    slots = inputs.pool_slots(cfg, traffic)
    assert slots * 2 * traffic["batch"] * inputs.ciphertext_bytes(cfg) >= 4 * 50e6
    # the cell reports setup_s and exactly the end-to-end metrics that list it
    listed = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", CELLS)}
    assert {"setup_s", *traffic["end_to_end"]} == listed


def test_benchmark_names_every_cell_and_reader():
    assert sorted(w["name"] for w in BENCH["workloads"]) == CELLS
    readers = bench_run.readers()
    assert sorted(m["name"] for m in BENCH["per_layer"]) == sorted(readers)
    for m in BENCH["per_layer"]:
        assert readers[m["name"]].UNIT == m["unit"]
        assert set(m["workloads"]) <= set(CELLS)


def test_configs_moduli_are_the_port_parameter_makers():
    from alchemy_tpu_torch.she import fast, hybrid

    for name, (L, dnum) in {"bgv_n2e15_L8_trivgad": (8, None),
                            "bgv_n2e15_L16_hybrid": (16, 4)}.items():
        cfg = bench_run.load("configs", name)
        p = fast.FastParams.make(15, L)
        assert tuple(cfg["qs"]) == p.qs and cfg["n"] == p.n
        if dnum:
            assert tuple(cfg["special_primes"]) == hybrid.HybridKS.make(p, dnum=dnum).ps


@pytest.mark.parametrize("key_switching", ["trivgad", "hybrid"])
@pytest.mark.parametrize("batch", [1, 2])
def test_run_on_cpu_is_correct(tiny, key_switching, batch):
    cfg, traffic = tiny.config(key_switching), tiny.traffic(batch)
    res = bench_run.run(cfg, traffic, 2**31 + 7, 0.2, False, "cpu")
    assert res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert res["compared_calls"] == min(traffic["kept_calls"], res["attempted"])
    assert set(res["metrics"]) == {"setup_s", *traffic["end_to_end"]}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"mismatch": {"value": 0, "limit": 0},
                             "bad_slots": {"value": 0, "limit": 0}}


def test_trace_summary_on_known_events():
    events = [("void tensor_intt_kernel<S>(unsigned*)", 0, 10),
              ("void digit_relin_kernel<S>(unsigned*)", 10, 40),
              ("void at::native::vectorized_elementwise_kernel<4>(int)", 50, 60),
              ("void hybrid_digit_relin_kernel<S>(unsigned*)", 55, 70),
              ("Memcpy HtoD (Pageable -> Device)", 100, 105)]
    s = trace.summarize(events, 200e-9, 2)
    assert s["busy_s"] == pytest.approx(65e-9)
    assert s["glue_s"] == pytest.approx(15e-9)
    assert s["ops"] == 5
    assert s["durations"]["digit_relin"] == [pytest.approx(30e-9)]
    assert "hybrid_digit_relin" in s["durations"] and "tensor_intt" in s["durations"]
    assert s["gaps"] == {"vectorized_elementwise_kernel": pytest.approx(10e-9),
                         "Memcpy HtoD": pytest.approx(30e-9)}
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["digit_relin", pytest.approx(30e-9)]
    assert b["idle_gaps"][0] == ["launch of Memcpy HtoD", pytest.approx(30e-9)]


def _ctx(cfg, traffic, summary, host_s=(0.001, 0.003, 0.002)):
    card = {"name": "card", "power_limit_w": 700.0, "clock_max_mhz": 1980.0}
    return {"cfg": cfg, "traffic": traffic, "trace": summary, "card": card, "notes": {},
            "window": {"host_s": list(host_s)}}


def test_readers_on_known_summaries(tiny):
    readers = bench_run.readers()
    summary = trace.summarize([("void digit_relin_kernel<S>()", 0, 1000),
                               ("void hybrid_digit_relin_kernel<S>()", 0, 1000),
                               ("void at::native::add()", 1000, 1500)], 2000e-9, 4)
    got = {}
    for ks, batch in (("trivgad", 2), ("hybrid", 2), ("trivgad", 1)):
        cfg, traffic = tiny.config(ks), tiny.traffic(batch)
        ctx = _ctx(cfg, traffic, summary)
        got[ks, batch] = {k: m.read(ctx) for k, m in readers.items()
                          if m.read(ctx) is not None}
    assert set(got["trivgad", 2]) == {"idle.batch", "digit_relin_roofline"}
    assert set(got["hybrid", 2]) == {"idle.batch", "glue_share.hybrid",
                                     "hybrid_digit_relin_roofline"}
    assert set(got["trivgad", 1]) == {"idle.single", "launches_per_call.single",
                                      "host_ms_per_call.single"}
    assert got["trivgad", 2]["idle.batch"] == pytest.approx(25.0)
    assert got["hybrid", 2]["glue_share.hybrid"] == pytest.approx(100 * 500 / 1500)
    assert got["trivgad", 1]["launches_per_call.single"] == pytest.approx(0.75)
    assert got["trivgad", 1]["host_ms_per_call.single"] == pytest.approx(2.0)
    assert 0 < got["trivgad", 2]["digit_relin_roofline"]


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_main_refuses_when_jax_is_loaded(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(bench_run, "run", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert bench_run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 3
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err


def test_command_fails_where_only_the_benchmark_is(tmp_path):
    """In a directory holding only BENCHMARK.json and benchmark/, the
    command exits non-zero and prints no result."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(BENCH["command"] + ["--workload", CELLS[0], "--seed", "3",
                                              "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_cell_on_the_card(cuda_device):
    proc = subprocess.run(BENCH["command"] + ["--workload", "trivgad.single", "--seed", "5",
                                              "--seconds", "1", "--trace", "1"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
