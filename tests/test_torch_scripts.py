"""alchemy_tpu_torch.scripts, the port's counterparts of the JAX package's
`scripts/`, on the CPU at tiny sizes: `verify_device.run_checks` returns
the JAX script's keys, all true; `bench_batch` and `bench_hybrid` give
records with the JAX keys plus `backend` and `card` and write only where
asked; `profile_trace` aggregates a profile; `microbench_mxu`'s int8
product is exact; and no new module imports jax or the JAX package."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from alchemy_tpu_torch import bench
from alchemy_tpu_torch.scripts import (
    bench_batch,
    bench_hybrid,
    microbench_mxu,
    profile_trace,
    verify_device,
)

ROOT = Path(__file__).resolve().parents[1]
TINY = {"mul_relin": (10, 3), "hybrid": (10, 5), "headline": (10, 3, 2)}
NEW_MODULES = ["bench", "scripts", *(f"scripts.{m}" for m in (
    "verify_device", "bench_hybrid", "bench_batch", "bench_examples", "bench_erw",
    "profile_trace", "profile_examples", "bench_pipeline", "bench_strategy",
    "bench_comm_fit", "microbench_mxu"))]


def _record(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


@pytest.fixture
def out_dir(monkeypatch, tmp_path):
    """build/bench/ of this run: a directory under tmp_path."""
    monkeypatch.setattr(bench, "OUT_DIR", tmp_path / "build_bench")
    return tmp_path / "build_bench"


def test_verify_device_has_the_jax_keys_all_true():
    src = (ROOT / "scripts" / "verify_device.py").read_text()
    jax_keys = set(re.findall(r'results\["(\w+)"\]', src))
    assert len(jax_keys) == 10 and verify_device.HEADLINE_KEY in jax_keys
    res = verify_device.run_checks("cpu", TINY)
    assert set(res) == jax_keys and all(res.values())


def test_bench_batch_record_and_decrypt(monkeypatch, capsys, tmp_path, out_dir):
    for k, v in {"BENCH_LOG_N": "10", "BENCH_NLIMB": "3", "BENCH_SECONDS": "0.02",
                 "BATCH_SIZES": "2,5"}.items():
        monkeypatch.setenv(k, v)
    assert bench_batch.main(device="cpu") == 0
    rec = _record(capsys.readouterr().out)
    assert set(rec) == {"metric", "unit", "config", "points", "device", "backend", "card"}
    assert rec["metric"] == "bgv_mul_relin_batched_simd_n2e10_L3"
    assert set(rec["points"]) == {"B2", "B5"}
    for pt in rec["points"].values():
        assert set(pt) == {"ops_per_s", "ms_per_ct_best", "ms_per_ct_median", "ms_per_ct_iqr",
                           "windows", "decrypt_pass"}
        assert pt["decrypt_pass"] and pt["windows"] == 5
    assert json.loads((out_dir / "bench_batch.json").read_text()) == rec
    path = tmp_path / "mine.json"
    assert bench_batch.main(argv=["--device", "cpu", "--out", str(path)]) == 0
    assert set(json.loads(path.read_text())) == set(rec)


def test_bench_hybrid_record(monkeypatch, capsys):
    for k, v in {"HB_LOG_N": "10", "HB_NLIMB": "5", "HB_SECONDS": "0.02",
                 "HB_IMPL": "pallas"}.items():
        monkeypatch.setenv(k, v)
    assert bench_hybrid.main(device="cpu") == 0
    rec = _record(capsys.readouterr().out)
    assert set(rec) == {"log_n", "nlimb", "impl", "groups", "K", "device", "hybrid_ms_per_op",
                        "hybrid_ops_per_s", "trivgad_ms_per_op", "trivgad_ops_per_s",
                        "trivgad_over_hybrid", "decrypt_parity", "backend", "card"}
    assert rec["decrypt_parity"] and rec["groups"] == [3, 2] and rec["K"] == 3


def test_busy_us_is_the_union_of_intervals():
    assert profile_trace.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    assert profile_trace.busy_us([]) == 0


def test_device_profile_on_the_cpu(capsys):
    x = torch.arange(1 << 12, dtype=torch.int64)

    def step(v):
        return (v * 3 + 1) % 7

    prof = profile_trace.device_profile(step, (x,), iters=4, device="cpu")
    assert prof["launches"] == sum(c for _, _, c in prof["events"]) > 0
    assert 0 <= prof["busy_us"] <= prof["span_us"] and 0 <= prof["idle_share"] <= 1
    assert [t for _, t, _ in prof["events"]] == sorted((t for _, t, _ in prof["events"]),
                                                      reverse=True)
    assert profile_trace.profile_step(step, (x,), 2, device="cpu")
    profile_trace.print_events(prof["events"], 4)
    assert "TOTAL device" in capsys.readouterr().out


def test_microbench_int8_product_is_exact():
    rec = microbench_mxu.run("cpu", (64, 16, 16), iters=2)
    assert rec["s8_exact"] and rec["backend"] == "torch-cpu" and rec["card"] is None
    assert {"s8_us", "s8_tops", "bf16_us", "bf16_tflops"} <= set(rec)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    """Every new module's source: no `import jax`, `from jax`, nor a module
    of `alchemy_tpu.`; and importing them all in a fresh process loads
    neither and touches no CUDA."""
    pkg = ROOT / "alchemy_tpu_torch"
    for name in NEW_MODULES:
        path = pkg / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = pkg / name.replace(".", "/") / "__init__.py"
        for node in ast.walk(ast.parse(path.read_text())):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import)
                    else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for mod in mods:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "alchemy_tpu"), (name, mod)
    code = ("import sys\n"
            + "".join(f"import alchemy_tpu_torch.{m}\n" for m in NEW_MODULES)
            + "import torch\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'alchemy_tpu')]\n"
            "assert not bad, bad\n"
            "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
