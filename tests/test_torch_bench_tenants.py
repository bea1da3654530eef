"""The benchmark's multi-tenant configuration (`benchmark/configs/
bgv_n2e15_L8_tenants64.json`, `benchmark/systems/bgv_tenants.py`), its plain
reference (`benchmark/reference_tenants.py`), its cost function
(`benchmark/roofline_tenants.py`) and its reader
(`benchmark/metrics/digit_relin_tenants_roofline.py`): the configuration is
the TrivGad one with 64 tenants; a run of a small form of it on the CPU is
judged 0 and 0, and a run whose index names the next tenant fails both
checks; the reader on a synthetic trace, and nothing in the other cells or
without the program's `tenants` attribute; neither the reference nor a run
loads JAX, and the reference loads nothing of the port.

Imports no JAX: the reference is held against the port."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from alchemy_tpu_torch.she import fast, tenants
from alchemy_tpu_torch.utils import profiling
from benchmark import inputs
from benchmark import reference_tenants as R
from benchmark import roofline, roofline_tenants
from benchmark import run as bench_run
from benchmark import trace

ROOT = Path(__file__).resolve().parents[1]
CELL = "trivgad.tenants64"
OTHER_CELLS = ("trivgad.batch16", "hybrid.batch16", "trivgad.single", "hybrid.single",
               "deep16.chain", "homomrlwr.call")
READER = "digit_relin_tenants_roofline"
CARD = {"name": "card", "power_limit_w": 700.0, "clock_max_mhz": 1980.0}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: the small int64 ops run many times faster so on a
    shared host than spread over its cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny() -> tuple[dict, dict]:
    """The configuration and traffic of the cell at n = 2^10, L = 3, with 3
    tenants and 4 rows a call."""
    _, cfg, traffic = bench_run.load_cell(CELL)
    p = fast.FastParams.make(10, 3)
    cfg = {**cfg, "n": p.n, "qs": list(p.qs), "tenants": 3}
    traffic = {**traffic, "batch": 4, "pool_min_bytes": 0, "warmup_calls": 1, "kept_calls": 2,
               "trace_calls": 2}
    return cfg, traffic


def test_configuration_is_trivgad_with_64_tenants():
    cell, cfg, traffic = bench_run.load_cell(CELL)
    base = bench_run.load("configs", "bgv_n2e15_L8_trivgad")
    same = ("n", "qs", "zp", "order", "key_switching", "shoup_hints", "variance", "limits")
    assert {k: cfg[k] for k in same} == {k: base[k] for k in same}
    assert (cfg["system"], cfg["tenants"], cfg["reduced"], cell["chips"]) == (
        "bgv_tenants", 64, [], 1)
    assert (traffic["batch"], traffic["sync_each_call"], traffic["tenant_zipf_s"]) == (16, False,
                                                                                      1.0)
    assert inputs.pool_slots(cfg, traffic) == 16
    p = R.zipf(64, 1.0)
    assert p[0] == pytest.approx(0.2108, abs=1e-4)
    assert sum(1 - (1 - p) ** 16) == pytest.approx(11.07, abs=0.01)   # distinct tenants a call
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    listed = {m["name"] for m in bench["end_to_end"] + bench["per_layer"]
              if CELL in m.get("workloads", [CELL])}
    assert listed == {"ct_mul_per_s", "setup_s", "idle.batch", READER}


def test_row_tenants_and_tenant_seeds_are_the_seeds():
    seed = 2**63 + 11
    ids = [R.row_tenants(seed, slot, 16, 64, 1.0) for slot in range(16)]
    assert ids == [R.row_tenants(seed, slot, 16, 64, 1.0) for slot in range(16)]
    assert all(0 <= t < 64 for row in ids for t in row) and len({tuple(r) for r in ids}) == 16
    seeds = [R.tenant_seed(seed, t) for t in range(64)]
    assert len(set(seeds)) == 64 and R.tenant_seed(-5, 0) == R.tenant_seed(2**64 - 5, 0)


def test_run_on_cpu_is_correct():
    cfg, traffic = _tiny()
    res = bench_run.run(cfg, traffic, 2**40 + 9, 0.2, False, "cpu")
    assert res["correct"] and res["failed"] == 0, res
    assert res["checks"] == {"mismatch": {"value": 0, "limit": 0},
                             "bad_slots": {"value": 0, "limit": 0}}
    assert set(res["metrics"]) == {"setup_s", "ct_mul_per_s"}


def test_rows_under_the_next_tenants_hints_fail_both_checks(monkeypatch):
    cfg, traffic = _tiny()
    batch = tenants.TenantKeys.batch
    monkeypatch.setattr(tenants.TenantKeys, "batch",
                        lambda self, ids: batch(self, [(t + 1) % self.tenants for t in ids]))
    res = bench_run.run(cfg, traffic, 2**40 + 9, 0.1, False, "cpu")
    assert not res["correct"]
    assert res["checks"]["mismatch"]["value"] > 0 and res["checks"]["bad_slots"]["value"] > 0


def test_cost_counts_each_distinct_tenants_hints():
    nbytes, muls = roofline.digit_relin_cost(16, 8, 1 << 15, True)
    assert roofline_tenants.digit_relin_tenants_cost(16, 8, 1 << 15, True, 1) == (
        nbytes + 64, muls)
    many, _ = roofline_tenants.digit_relin_tenants_cost(16, 8, 1 << 15, True, 11)
    assert many - nbytes - 64 == 10 * 4 * 4 * 8 * 8 * (1 << 15)
    # at the cell's mean of distinct tenants B is bound by bytes, not multiplies
    bound_ms, by = roofline.bound(*roofline_tenants.digit_relin_tenants_cost(
        16, 8, 1 << 15, True, 11.07), 1.98e9)
    assert by == "bytes" and bound_ms == pytest.approx(0.1366, abs=1e-3)


@pytest.fixture
def clock(monkeypatch):
    """The recorder's clock, set by hand: spans read `clock.now`."""
    c = SimpleNamespace(now=0, perf_counter=time.perf_counter)
    c.time_ns = lambda: c.now
    monkeypatch.setattr(profiling, "time", c)
    profiling.reset()
    yield c
    profiling.reset()


def _roots(clock, tenants_of_calls, cfg, batch: int) -> None:
    """One `mul_relin` root a call at the cell's shape, with its `tenants`
    (None: the attribute left out, as a program without it records)."""
    for i, t in enumerate(tenants_of_calls):
        clock.now = 1000 * i
        with profiling.tracing(), profiling.span("mul_relin") as root:
            root.attrs.update(batch=batch, L=len(cfg["qs"]), n=cfg["n"])
            if t is not None:
                root.attrs["tenants"] = t
            clock.now += 100


#: two launches of the tenant-indexed kernel, 0.3 and 0.5 ms, and kernel A
EVENTS = [("void (anonymous namespace)::tensor_intt_kernel<S, 1>(unsigned int const*)",
           0, 10**5),
          ("void (anonymous namespace)::digit_relin_tenants_kernel<(anonymous namespace)::"
           "Shape<1024, 1, 3, true, false>>(unsigned int const*, int const*, int, int)",
           10**5, 4 * 10**5),
          ("void (anonymous namespace)::digit_relin_tenants_kernel<(anonymous namespace)::"
           "Shape<1024, 1, 3, true, false>>(unsigned int const*, int const*, int, int)",
           5 * 10**5, 10**6)]


def _ctx(cell: str, summary) -> dict:
    _, cfg, traffic = bench_run.load_cell(cell)
    return {"cfg": cfg, "traffic": traffic, "trace": summary, "window": {"host_s": [0.02]},
            "card": CARD, "notes": {}}


def test_reader_on_a_synthetic_trace(clock):
    ctx = _ctx(CELL, trace.summarize(EVENTS, 2e-3, 2))
    _roots(clock, [5, 9, 12], ctx["cfg"], 16)            # the slice is the last two calls
    readers = bench_run.readers()
    got = {name: mod.read(ctx) for name, mod in readers.items()}
    assert {k for k, v in got.items() if v is not None} == {"idle.batch", READER}
    bound_ms, by = roofline.bound(*roofline_tenants.digit_relin_tenants_cost(
        16, 8, 1 << 15, True, 10.5), 1.98e9)
    assert got[READER] == pytest.approx(100 * bound_ms / 0.4)
    assert ctx["notes"][READER] == {"bound_ms": pytest.approx(bound_ms), "bound_by": by,
                                    "ms": pytest.approx(0.4), "launches": 2,
                                    "tenants_mean": 10.5, "calls": 2, **CARD}


def test_reader_reads_nothing_without_the_programs_kernel_or_attribute(clock):
    reader = bench_run.readers()[READER]
    ctx = _ctx(CELL, trace.summarize(EVENTS, 2e-3, 2))
    _roots(clock, [None, None], ctx["cfg"], 16)          # a program without `tenants`
    assert reader.read(ctx) is None
    _roots(clock, [3, 3], ctx["cfg"], 16)
    assert reader.read(ctx) is not None
    assert reader.read(_ctx(CELL, trace.summarize(EVENTS[:1], 2e-3, 2))) is None
    assert reader.read(_ctx(CELL, None)) is None


@pytest.mark.parametrize("cell", OTHER_CELLS)
def test_reader_reads_nothing_in_the_other_cells(clock, cell):
    ctx = _ctx(cell, trace.summarize(EVENTS, 2e-3, 2))
    _roots(clock, [4, 4], {"qs": [0] * 8, "n": 1 << 15}, 16)
    assert bench_run.readers()[READER].read(ctx) is None


def test_neither_the_reference_nor_a_run_loads_jax():
    """The reference loads nothing of the port; a whole run of the cell's
    small form on the CPU loads neither JAX nor the JAX package."""
    code = ("import sys, json, torch; torch.set_num_threads(1)\n"
            "import benchmark.reference_tenants, benchmark.roofline_tenants\n"
            "names = {'jax', 'jaxlib', 'alchemy_tpu', 'alchemy_tpu_torch'}\n"
            "ref = sorted({m.split('.')[0] for m in sys.modules} & names)\n"
            "from tests.test_torch_bench_tenants import _tiny\n"
            "from benchmark import run\n"
            "cfg, traffic = _tiny()\n"
            "res = run.run(cfg, traffic, 3, 0.05, False, 'cpu')\n"
            "print(json.dumps([ref, res['correct'], run.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [[], True, []]


def test_reference_keys_are_the_systems():
    """The reference works out tenant t's key from its seed as the system
    draws it: the same key in the NTT domain, residue for residue."""
    from benchmark import reference

    cfg, _ = _tiny()
    p = fast.FastParams(n=cfg["n"], qs=tuple(cfg["qs"]), zp=cfg["zp"], impl=cfg["order"])
    for t in (0, 2):
        ts = R.tenant_seed(77, t)
        s = fast.keygen(p, inputs.stream(ts, inputs.KEY), cfg["variance"], device="cpu")
        keys = reference.Keys(cfg, ts, "cpu")
        assert np.array_equal(s.numpy().astype(np.int64) & 0xFFFFFFFF, keys.s.numpy())
