"""alchemy_tpu_torch.scripts on the shipped examples, on the CPU at the
smallest one (Arithmetic): `bench_examples` and `bench_erw` give records
with the JAX scripts' keys plus `backend` and `card`; `bench_erw`'s per-op
error rates equal those of the JAX package's `jit_compile(...,
noise_probe=)` on the same program, keys and seed (the JAX script's
recipe); `profile_examples` counts the same base MACs as the JAX package's
`MAC_COUNTER` over the program's trace."""

import json

import numpy as np
import pytest

import alchemy_tpu.examples.arithmetic as jarith
from alchemy_tpu.backend import xla as jxla
from alchemy_tpu.backend import xla_backend
from alchemy_tpu.core.cyc import Cyc as JCyc
from alchemy_tpu.interp.jit_exec import jit_compile as jjit
from alchemy_tpu.interp.keys_hints import KeysHints as JKeysHints
from alchemy_tpu.interp.pt2ct import pt2ct as jpt2ct
from alchemy_tpu.nt.factor import totient
from alchemy_tpu.she.gadget import TrivGad as JTrivGad
from alchemy_tpu_torch import bench
from alchemy_tpu_torch.scripts import bench_erw, bench_examples, profile_examples


@pytest.fixture(autouse=True)
def _no_aot_cache(monkeypatch, tmp_path):
    # the JAX package's jit_compile would otherwise write its artifacts to /tmp
    monkeypatch.setenv("ALCHEMY_AOT_CACHE", "0")
    monkeypatch.setattr(bench, "OUT_DIR", tmp_path / "build_bench")


def _jax_arithmetic(seed: int):
    """`bench_examples.build("arithmetic")`'s recipe on the JAX package."""
    bk = xla_backend()
    rng = np.random.default_rng(seed)
    ctx = JKeysHints(3.0, seed=1, bk=bk)
    compiled = jpt2ct(jarith.addMul, res_ty=jarith.PT, m_map=jarith.M_MAP, zqs=jarith.ZQS,
                      gad=JTrivGad(), ctx=ctx)
    xs = [JCyc.from_coeffs(jarith.M, (jarith.ZP,), rng.integers(0, jarith.ZP, totient(jarith.M)),
                           bk) for _ in range(2)]
    return ctx, compiled, [compiled.encrypt_arg(x, i) for i, x in enumerate(xs)]


def _records(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_bench_examples_arithmetic(monkeypatch, capsys):
    monkeypatch.setenv("EX_ONLY", "arithmetic")
    monkeypatch.setenv("EX_SECONDS", "0.01")
    assert bench_examples.main(device="cpu") == 0
    (rec,) = _records(capsys.readouterr().out)
    assert set(rec) == {"workload", "keygen_compile_s", "build_s", "ms_per_run", "platform",
                        "pass", "backend", "card"}
    assert rec["pass"] and rec["platform"] == "cpu" and rec["workload"] == "arithmetic"


def test_bench_erw_rates_match_the_jax_script(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("ERW_ONLY", "arithmetic")
    path = tmp_path / "erw.json"
    assert bench_erw.main(device="cpu", out=str(path)) == 0
    rec = json.loads(capsys.readouterr().out)
    assert set(rec) == {"workload", "device", "decrypt_pass", "keygen_compile_s",
                        "probe_build_lower_s", "first_call_s", "ms_per_run_with_probe",
                        "per_op_error_rates", "note", "backend", "card"}
    assert rec["decrypt_pass"] and json.loads(path.read_text())["workloads"]["arithmetic"] == rec
    ctx, compiled, cts = _jax_arithmetic(1)
    _, rates = jjit(compiled, cts, noise_probe=ctx)(*cts)
    assert rec["per_op_error_rates"] == [{"op": lbl, "rate": float(r)} for lbl, r in rates]
    assert len(rates) >= 4


def test_profile_examples_counts_the_jax_macs(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("EXP_ONLY", "arithmetic")
    monkeypatch.setenv("EXP_ITERS", "1")
    path = tmp_path / "prof.json"
    assert profile_examples.main(device="cpu", out=str(path)) == 0
    out = capsys.readouterr().out
    rec = json.loads(out[:out.rindex("}") + 1])
    assert set(rec) == {"workload", "device_us_per_step", "data_movement_us", "compute_us",
                        "data_movement_pct", "device_ops_per_step", "transform_groups_per_step",
                        "exact_base_macs_per_step", "mxu_floor_us", "floor_model",
                        "gap_to_floor", "trace_compile_s", "top_ops", "backend", "card"}
    assert json.loads(path.read_text()) == {"workloads": [rec]}
    # the program's own transforms: the counter on around its trace only (the
    # JAX script also leaves it on while it makes the keys and ciphertexts)
    ctx, compiled, cts = _jax_arithmetic(bench_examples.SEEDS["arithmetic"])
    jxla.MAC_COUNTER = []
    try:
        jjit(compiled, cts)(*cts)
        macs = list(jxla.MAC_COUNTER)
    finally:
        jxla.MAC_COUNTER = None
    assert rec["transform_groups_per_step"] == len(macs) > 0
    assert rec["exact_base_macs_per_step"] == sum(L * di * do * R for L, di, do, R in macs)
