"""alchemy_tpu_torch.bench, the port's counterpart of the JAX package's
`bench.py`: the inputs and one step equal what the JAX package builds in
bench.py:87-125's order from the same seed (n = 2^10, L = 3, Bt = 2, rng 0,
impl "vpu"), bit for bit; the record of `main(device="cpu")` has the keys of
`python bench.py` run on the CPU at the same knobs plus `backend` and
`card`; the timing loop, the decrypt check and the refusal to run without a
card."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alchemy_tpu.she import fast as jfast
from alchemy_tpu.she import hybrid as jhyb
from alchemy_tpu_torch import bench
from alchemy_tpu_torch.convert import to_numpy
from alchemy_tpu_torch.she import fast as tfast

ROOT = Path(__file__).resolve().parents[1]
KNOBS = {"BENCH_LOG_N": "10", "BENCH_NLIMB": "3", "BENCH_SECONDS": "0.05", "BENCH_BATCH": "2"}


def _flat(h):
    return list(h) if isinstance(h, (tuple, list)) else [h]


def _jax_step(ks: str, batch: int, chain: int, shoup_hybrid: bool):
    """bench.py:87-125 with the JAX package at n = 2^10, L = 3, impl vpu."""
    p = jfast.FastParams.make(10, 3, zp=2, impl="vpu")
    rng = np.random.default_rng(0)
    if ks == "hybrid":
        hk = jhyb.HybridKS.make(p)
        s, (hb, ha) = jhyb.hybrid_keygen_hint(hk, rng)
        if shoup_hybrid:
            hb = jfast.shoup_precompute(hb, hk.pe.qs)
            ha = jfast.shoup_precompute(ha, hk.pe.qs)

        def mul(a, b):
            return jhyb.mul_relin_hybrid(hk, a, b, hb, ha)
    else:
        s = jfast.keygen(p, rng)
        hb, ha = jfast.relin_hint(p, s, rng, shoup=True)

        def mul(a, b):
            return jfast.mul_relin(p, a, b, hb, ha)
    ct1 = jfast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
    ct2 = jfast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
    if batch > 1:
        ct1 = jnp.broadcast_to(ct1[None], (batch, *ct1.shape))
        ct2 = jnp.broadcast_to(ct2[None], (batch, *ct2.shape))
    o = ct2
    for _ in range(chain):
        o = mul(ct1, o)
    return {"s": s, "hb": hb, "ha": ha, "ct1": ct1, "ct2": ct2, "out": o}


@pytest.mark.parametrize("ks, batch, chain, shoup_hybrid", [
    ("trivgad", 2, 1, False), ("hybrid", 2, 1, False), ("trivgad", 1, 2, False),
    ("hybrid", 2, 2, True)])
def test_bench_inputs_and_step_match_jax(monkeypatch, ks, batch, chain, shoup_hybrid):
    if shoup_hybrid:
        monkeypatch.setenv("BENCH_HYBRID_SHOUP", "1")
    want = _jax_step(ks, batch, chain, shoup_hybrid)
    p = tfast.FastParams.make(10, 3, zp=2, impl="vpu")
    inp = bench.bench_inputs(p, np.random.default_rng(0), ks, "cpu", batch)
    o = inp["ct2"]
    for _ in range(chain):
        o = inp["mul"](inp["ct1"], o)
    assert inp["ct1"].is_contiguous() and inp["ct1"].shape[0] == batch or batch == 1
    assert np.array_equal(np.asarray(want["s"]), to_numpy(inp["s"]))
    for key in ("hb", "ha"):
        got, ref = _flat(inp[key]), _flat(want[key])
        assert len(got) == len(ref) == (2 if ks == "trivgad" or shoup_hybrid else 1)
        assert all(np.array_equal(np.asarray(r), to_numpy(g)) for g, r in zip(got, ref))
    for key in ("ct1", "ct2"):
        assert np.array_equal(np.asarray(want[key]), to_numpy(inp[key]))
    assert np.array_equal(np.asarray(want["out"]), to_numpy(o))


def _record(text: str) -> dict:
    return json.loads([ln for ln in text.splitlines() if ln.startswith("{")][-1])


def test_record_keys_match_the_jax_bench(monkeypatch, capsys, tmp_path):
    """`python bench.py` on the CPU (its compile cache sent to tmp_path) and
    the port's main(device="cpu") at the same knobs: the same keys, plus
    backend and card; the same metric name, batch and dispersion keys."""
    code = ("import jax, runpy\n"
            "update = jax.config.update\n"
            f"jax.config.update = lambda k, v: update(k, {str(tmp_path)!r} "
            "if k == 'jax_compilation_cache_dir' else v)\n"
            "runpy.run_path('bench.py', run_name='__main__')\n")
    env = {**os.environ, **KNOBS, "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    ref = _record(out.stdout)
    for k, v in KNOBS.items():
        monkeypatch.setenv(k, v)
    assert bench.main(device="cpu") == 0
    got = _record(capsys.readouterr().out)
    assert set(got) == set(ref) | {"backend", "card"}
    assert got["backend"] == "torch-cpu" and got["card"] is None
    assert (got["metric"], got["batch"], got["unit"]) == (ref["metric"], ref["batch"], ref["unit"])
    assert set(got["dispersion"]) == set(ref["dispersion"])
    assert got["vs_baseline"] == ref["vs_baseline"] == 1.0       # the run is the CPU run
    assert got["latency_1ct_ms"] > 0 and got["ntt_us_qd1"] > 0


def test_record_keys_on_the_card_are_bench_pys():
    """On an accelerator bench.py adds `sweep` and `native_kernel_checks` to
    the CPU record; RECORD_KEYS is that set plus backend and card."""
    src = (ROOT / "bench.py").read_text()
    assert 'rec["sweep"]' in src and 'rec["native_kernel_checks"]' in src
    cpu_keys = {"metric", "value", "unit", "vs_baseline", "batch", "value_semantics",
                "latency_1ct_ms", "dispersion", "ntt_us_qd1", "ntt_us_qd8"}
    assert all(f'"{k}":' in src for k in cpu_keys)
    assert set(bench.RECORD_KEYS) == cpu_keys | {"sweep", "native_kernel_checks", "backend",
                                                 "card"}


def test_timed_loop_doubles_then_takes_windows():
    calls = []

    def step(s):
        calls.append(s)
        return s + 1

    ops, per, stats = bench._timed_loop(step, 0, min_seconds=0.0, windows=5, device="cpu")
    assert len(calls) == 4 * 5 and calls == list(range(20))
    assert stats["windows"] == 5 and stats["best"] == per and ops == 1.0 / per
    assert stats["best"] <= stats["median"] and stats["iqr"] >= 0
    calls.clear()
    bench._timed_loop(step, 0, min_seconds=0.0, windows=3, iters=1, device="cpu")
    assert len(calls) == 3


def test_decrypt_check_catches_a_wrong_product():
    p = tfast.FastParams.make(10, 3, zp=2, impl="vpu")
    inp = bench.bench_inputs(p, np.random.default_rng(0), "trivgad", "cpu", 3)
    out = inp["mul"](inp["ct1"], inp["ct2"])
    assert bench.decrypts(p, inp, out, 1)
    assert not bench.decrypts(p, inp, out, 2)
    m1, m2 = inp["msgs"]
    assert not bench.decrypts(p, {**inp, "msgs": [m1, 1 - m2]}, out, 1)
    assert not bench.decrypts(p, inp, torch.cat([out[:2], inp["ct2"][:1]]), 1)


def test_no_card_no_run(monkeypatch):
    """The entry points run on the card unless asked for the CPU, and
    without a card they exit non-zero instead of measuring the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: bench.main(), lambda: bench.main(argv=[]),
                 lambda: bench.run_args("x", argv=["--device", "cuda"])):
        with pytest.raises(SystemExit) as e:
            call()
        assert e.value.code not in (0, None)
    assert bench.run_args("x", argv=["--device", "cpu"]).device == "cpu"
    args = bench.run_args("x", argv=["--out", "p", "--cards", "2"], device="cpu", writes=True,
                          cards=True)
    assert (args.device, args.out, args.cards) == ("cpu", "p", 2)
    assert bench.world_backend("cuda", 2, 2) == "nccl"
    assert bench.world_backend("cuda", 1, 2) == bench.world_backend("cpu", 4, 2) == "gloo"


@pytest.mark.cuda
def test_graph_step_matches_eager_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = tfast.FastParams.make(14, 4, zp=2, impl="pallas")
    for ks in ("trivgad", "hybrid"):
        inp = bench.bench_inputs(p, np.random.default_rng(0), ks, "cuda", 4)

        def fn(o):
            return inp["mul"](inp["ct1"], inp["mul"](inp["ct1"], o))

        step, out = bench.compiled_step(fn, inp["ct2"])
        # fresh allocations of the input's size must not land on the graph's
        # input buffer
        junk = [torch.full_like(inp["ct2"], 7) for _ in range(4)]
        eager = fn(inp["ct2"])
        assert torch.equal(step(out), eager) and bench.decrypts(p, inp, out, 2)
        assert all(bool((j == 7).all()) for j in junk)
