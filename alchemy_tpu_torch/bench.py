"""Benchmark: BGV ciphertext multiply + relinearization throughput on one
card — port of `bench.py` (the JAX package's benchmark harness).

North-star config: ring with 2^15 coefficients (m' = 2^16), 8 RNS limbs
(~30-bit NTT primes), CRT-gadget relinearization (TrivGad, Shoup hint
pairs), 16 ciphertexts a call: `she/fast.py`'s `mul_relin` through CUDA
kernels A and B; `BENCH_KS=hybrid` times `she/hybrid.py`'s
`mul_relin_hybrid` (kernels A, `garner_pack`, 4, then in `rescale_joint`
5 on the dropped rows alone and 7).

    python -m alchemy_tpu_torch.bench                 # on the card
    python -m alchemy_tpu_torch.bench --device cpu    # the plain versions

Knobs, names and defaults as in `bench.py`: BENCH_LOG_N (15), BENCH_NLIMB
(8), BENCH_SECONDS (2.0), BENCH_BATCH (16), BENCH_CHAIN (1), BENCH_KS
(trivgad | hybrid), BENCH_IMPL (pallas, also mxu, mxu8, vpu; on the CPU
the run takes vpu, as `bench.py` does), BENCH_SWEEP (1), BENCH_NATIVE (1),
BENCH_HYBRID_SHOUP (0).

The step is one CUDA graph of `chain` dependent calls, captured after a
warm-up (the counterpart of the JAX step, one jitted program), replayed by
the timing loop; on the CPU it runs eagerly. Prints ONE JSON line on
stdout, `bench.py`'s record with the same keys (RECORD_KEYS) plus
`backend` ("torch-cuda" or "torch-cpu") and `card` (`nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`, null on the CPU).
`vs_baseline` is the card against the same op, batch and chain on this
machine's CPU through the port's plain versions (impl vpu).
`native_kernel_checks` is `scripts/verify_device.run_checks` on the card.
Details go to stderr. A failing sweep point, CPU baseline or kernel check
raises; a check that returns false makes the run exit 1 after it prints its
record. Writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

#: the keys of `bench.py`'s record on an accelerator (bench.py:267-303), then
#: the port's two
RECORD_KEYS = ("metric", "value", "unit", "vs_baseline", "batch", "value_semantics",
               "latency_1ct_ms", "dispersion", "ntt_us_qd1", "ntt_us_qd8", "sweep",
               "native_kernel_checks", "backend", "card")
#: the CPU baseline's timing loop: one call to start, and this many windows
BASELINE_WINDOWS = 2
#: where the harness's scripts write their records (git-ignored)
OUT_DIR = Path(__file__).resolve().parents[1] / "build" / "bench"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def run_args(description: str, device: str | None = None, argv=None, out: str | None = None,
             writes: bool = False, cards: bool = False) -> argparse.Namespace:
    """The run's `device`, and for a script that writes a file (`writes`)
    its `out`, and for one that starts rank processes (`cards`) the
    `cards` its ranks may take one each: what the caller passes, else
    `--device` (default "cuda"), `--out` and `--cards` (default 1) of argv.
    "cuda" without a card raises SystemExit: a measurement never falls back
    to the CPU."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    if writes:
        ap.add_argument("--out", help="path of the record (default: under build/bench/)")
    if cards:
        ap.add_argument("--cards", type=int, default=1,
                        help="cards for the rank processes, one each (NCCL from 2)")
    args = ap.parse_args(list(argv or ()))
    args.device = device or args.device
    args.out = out or getattr(args, "out", None)
    if args.device not in ("cuda", "cpu"):
        raise ValueError(f"device={args.device!r}: want 'cuda' or 'cpu'")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{description}: no CUDA device")
    return args


def world_backend(device: str, cards: int, ranks: int) -> str:
    """The transport of a world of `ranks` rank processes: NCCL when they
    run on the card and `cards` cards hold one rank each (NCCL refuses two
    ranks on one GPU), else gloo (ranks on the CPU, or sharing a card)."""
    return "nccl" if device == "cuda" and cards >= ranks else "gloo"


def on_ranks(world, ranks: int, transport: str, fn, *args) -> list:
    """fn(*args) on every rank of `world`, or of a LocalWorld of `ranks`
    ranks over `transport` started for the call; the results in rank
    order."""
    from alchemy_tpu_torch.parallel.multihost import LocalWorld

    if world is not None:
        return world.run(fn, *args)
    with LocalWorld(ranks, backend=transport) as w:
        return w.run(fn, *args)


def share_cpu(device: str) -> None:
    """In a rank process on the CPU: an equal share of the cores for each
    rank of the world (torch's default of every core per rank
    oversubscribes them and its threads spin-wait on each other)."""
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // dist.get_world_size()))


def backend(device: str) -> str:
    return f"torch-{device}"


def card(device: str) -> str | None:
    """The card's name and power limit as nvidia-smi prints them (None on
    the CPU)."""
    if device != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def write_record(rec, name: str, out: str | None = None) -> Path:
    """Write `rec` as JSON to `out`, or to build/bench/<name>."""
    path = Path(out) if out else OUT_DIR / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(rec, indent=1))
    return path


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def compiled_step(fn, x: torch.Tensor):
    """(step, state) for `_timed_loop`, where step(state) is fn(x): on the
    card, fn(x) captured in one CUDA graph after a warm-up on a side stream
    (which fills every upload cache; `interp/jit_exec.py`'s route), each
    step one replay from the same input buffer into the same output buffer
    (replays run in order on the stream, so every step does the whole
    work), the state that output; on the CPU, fn called eagerly on the
    state, x (no warm-up call: a plain call takes seconds at full size)."""
    if x.device.type != "cuda":
        return fn, x
    static = x.clone()
    cur = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        fn(static)
    cur.wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    mode = torch.cuda.get_sync_debug_mode()
    with torch.cuda.graph(graph):
        # a sync or a host copy inside the step raises here, at the op
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn(static)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    graph.replay()

    def step(_state):
        graph.replay()
        return out

    # the graph reads `static` in place: it lives as long as the step (freed,
    # its memory would go to the next allocation and the replays read that)
    step.static = static
    return step, out


def _timed_loop(step, state, min_seconds: float = 1.0, windows: int = 5, iters: int = 4,
                device="cuda"):
    """Run `state = step(state)` until the measured span exceeds min_seconds
    (doubling the iteration count from `iters`), synchronizing the card at
    the end of each span (bench.py:37). The final count is re-measured over
    `windows` spans; the headline is the best window, with median and IQR
    over the windows beside it."""
    while True:
        t0 = time.perf_counter()
        s = state
        for _ in range(iters):
            s = step(s)
        sync(device)
        dt = time.perf_counter() - t0
        if dt >= min_seconds or iters >= 1 << 20:
            break
        iters *= 2
    spans = [dt]
    for _ in range(max(0, windows - 1)):
        t0 = time.perf_counter()
        for _ in range(iters):
            s = step(s)
        sync(device)
        spans.append(time.perf_counter() - t0)
    per = np.sort(np.asarray(spans) / iters)
    stats = {
        "best": float(per[0]),
        "median": float(np.median(per)),
        "iqr": float(np.percentile(per, 75) - np.percentile(per, 25)),
        "windows": len(per),
    }
    best = float(per[0])
    return 1.0 / best, best, stats


def bench_inputs(p, rng: np.random.Generator, ks: str = "trivgad", device="cuda",
                 batch: int = 1) -> dict:
    """The inputs of `bench_on` in bench.py:87-120's order from rng: keys and
    hints (TrivGad: `fast.keygen`, Shoup `relin_hint`; hybrid:
    `hybrid_keygen_hint`, raw hints unless BENCH_HYBRID_SHOUP=1), then two
    encryptions, expanded to `batch` ciphertexts and made contiguous once.
    Returns {"s", "hb", "ha", "ct1", "ct2", "msgs", "mul": mul(a, b)}."""
    from alchemy_tpu_torch.she import fast

    if ks == "hybrid":
        from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_keygen_hint, mul_relin_hybrid

        hk = HybridKS.make(p)
        s, (hb, ha) = hybrid_keygen_hint(hk, rng, device=device)
        # raw hints: the JAX package measured Shoup companions slower for
        # hybrid on the TPU (bench.py:95-99); BENCH_HYBRID_SHOUP=1 flips
        if os.environ.get("BENCH_HYBRID_SHOUP") == "1":
            hb = fast.shoup_precompute(hb, hk.pe.qs)
            ha = fast.shoup_precompute(ha, hk.pe.qs)

        def mul(a, b):
            return mul_relin_hybrid(hk, a, b, hb, ha)
    elif ks == "trivgad":
        s = fast.keygen(p, rng, device=device)
        hb, ha = fast.relin_hint(p, s, rng, shoup=True)

        def mul(a, b):
            return fast.mul_relin(p, a, b, hb, ha)
    else:
        raise ValueError(f"ks={ks!r}: want 'trivgad' or 'hybrid'")
    msgs, cts = [], []
    for _ in range(2):
        msgs.append(rng.integers(0, p.zp, p.n))
        cts.append(fast.encrypt(p, s, msgs[-1], rng))
    ct1, ct2 = cts
    if batch > 1:
        ct1 = ct1.expand(batch, *ct1.shape).contiguous()
        ct2 = ct2.expand(batch, *ct2.shape).contiguous()
    return {"s": s, "hb": hb, "ha": ha, "ct1": ct1, "ct2": ct2, "msgs": msgs, "mul": mul}


def negacyclic_mod(m1, m2, zp: int) -> np.ndarray:
    """m1·m2 in Z_zp[X]/(X^n + 1) (exact through a float64 FFT for |products|
    < 2^52)."""
    from scipy.signal import fftconvolve

    n = len(m1)
    c = np.rint(fftconvolve(np.asarray(m1, np.float64), np.asarray(m2, np.float64)))
    c = c.astype(np.int64)
    return (c[:n] - np.concatenate([c[n:], [0]])) % zp


def decrypts(p, inp: dict, out: torch.Tensor, chain: int) -> bool:
    """Whether the step's output holds `chain` products of ct1 into ct2
    (m1^chain · m2 mod zp) in every ciphertext: the batch rows are equal
    on the device, and the first and last rows decrypt."""
    from alchemy_tpu_torch.she import fast

    want = np.asarray(inp["msgs"][1]) % p.zp
    for _ in range(chain):
        want = negacyclic_mod(inp["msgs"][0], want, p.zp)
    rows = out.reshape(-1, *out.shape[-3:])
    same = bool((rows == rows[:1]).all())
    return same and all(np.array_equal(fast.decrypt(p, inp["s"], rows[i]), want)
                        for i in {0, len(rows) - 1})


def bench_on(device, p, rng, min_seconds=1.0, batch: int = 1, chain: int = 1,
             ks: str = "trivgad", windows: int = 5, iters: int = 4, check: bool = False):
    """Throughput of ct mult+relin (bench.py:75): (ops/s, s per op, stats
    per op). `chain` dependent ops make one step, one CUDA graph on the
    card. With check=True, stats["decrypt_pass"] says whether the output
    decrypts (`decrypts`)."""
    inp = bench_inputs(p, rng, ks, device, batch)
    mul, ct1 = inp["mul"], inp["ct1"]

    def fn(o):
        for _ in range(chain):
            o = mul(ct1, o)
        return o

    step, state = compiled_step(fn, inp["ct2"])
    sync(device)
    ops, per, stats = _timed_loop(step, state, min_seconds, windows, iters, device)
    scale = batch * chain
    stats = {k: (v / scale if k != "windows" else v) for k, v in stats.items()}
    if check:
        stats["decrypt_pass"] = decrypts(p, inp, step(inp["ct2"]), chain)
    return ops * scale, per / scale, stats


def bench_ntt(device, p, min_seconds=1.0, batch: int = 1):
    """Standalone NTT latency (bench.py:138): `fast._ntt_p` (kernel 6 in the
    "pallas" order, 8 in "mxu") of [L, n], or [batch, L, n] in one call —
    per-transform time at queue depth `batch`."""
    from alchemy_tpu_torch.she.fast import _ntt_p

    rng = np.random.default_rng(0)
    x = np.stack([rng.integers(0, q, p.n) for q in p.qs]).astype(np.uint32)
    if batch > 1:
        x = np.stack([x] * batch)
    xd = torch.from_numpy(x.view(np.int32)).to(device)
    step, y = compiled_step(lambda v: _ntt_p(p, v), xd)
    sync(device)
    ops, lat, _ = _timed_loop(step, y, min_seconds, device=device)
    return lat / batch


def launch_counts() -> dict:
    """The kernel wrappers' launch counters (a graph's replays are not
    counted: its capture is one launch of each kernel in it)."""
    from alchemy_tpu_torch.backend.cuda.launch import LAUNCHES

    return {k: v for k, v in LAUNCHES.items() if v}


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.she.fast import FastParams

    device = run_args("alchemy_tpu_torch.bench", device, argv).device
    log_n = int(os.environ.get("BENCH_LOG_N", "15"))
    nlimb = int(os.environ.get("BENCH_NLIMB", "8"))
    secs = float(os.environ.get("BENCH_SECONDS", "2.0"))
    # default batch 16: per-card throughput; the single-ct latency is
    # measured separately (latency_1ct_ms)
    batch = int(os.environ.get("BENCH_BATCH", "16"))
    chain = int(os.environ.get("BENCH_CHAIN", "1"))
    ks = os.environ.get("BENCH_KS", "trivgad")
    accel_impl = os.environ.get("BENCH_IMPL", "pallas")
    impl = accel_impl if device == "cuda" else "vpu"
    p = FastParams.make(log_n, nlimb, zp=2, impl=impl)
    rng = np.random.default_rng(0)
    name = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    log(f"device: {name} | ring n=2^{log_n}, limbs={nlimb}, impl={p.impl}")

    ops_accel, per_op, stats = bench_on(device, p, rng, secs, batch=batch, chain=chain, ks=ks)
    log(f"mul_relin on {device} (batch={batch}, chain={chain}, ks={ks}): "
        f"{ops_accel:.2f} ops/s ({per_op*1e3:.3f} ms/op; median "
        f"{stats['median']*1e3:.3f} ms, IQR {stats['iqr']*1e3:.3f} ms over "
        f"{stats['windows']} windows)")

    lat_1ct = None
    if batch > 1:
        _, lat_1ct, _ = bench_on(device, p, np.random.default_rng(0), min(secs, 1.5), batch=1,
                                 chain=chain, ks=ks)
        log(f"single-ct latency: {lat_1ct*1e3:.3f} ms")

    ntt_lat = bench_ntt(device, p, secs)
    ntt_lat_b8 = bench_ntt(device, p, min(secs, 2.0), batch=8)
    log(f"NTT (n=2^{log_n}, {nlimb} limbs) latency: {ntt_lat*1e6:.0f} us "
        f"(amortized at queue depth 8: {ntt_lat_b8*1e6:.0f} us)")

    # the 2^14–2^16 ring range at the same limb count, impl and ks
    # (BENCH_SWEEP=0 to skip); a failing point raises
    sweep = {}
    if os.environ.get("BENCH_SWEEP", "1") != "0" and device == "cuda":
        for ln in (14, 15, 16):
            if ln == log_n:
                sweep[f"n2e{ln}"] = {
                    "mul_relin_ops_per_s": round(ops_accel, 3),
                    "ms_median": round(stats["median"] * 1e3, 4),
                    "ms_iqr": round(stats["iqr"] * 1e3, 4),
                    "ntt_us": round(ntt_lat * 1e6, 1),
                    "ntt_us_qd8": round(ntt_lat_b8 * 1e6, 1),
                }
                continue
            ps = FastParams.make(ln, nlimb, zp=2, impl=p.impl)
            o, _, st = bench_on(device, ps, np.random.default_rng(0), min(secs, 2.0),
                                batch=batch, ks=ks)
            nl = bench_ntt(device, ps, min(secs, 2.0))
            sweep[f"n2e{ln}"] = {
                "mul_relin_ops_per_s": round(o, 3),
                "ms_median": round(st["median"] * 1e3, 4),
                "ms_iqr": round(st["iqr"] * 1e3, 4),
                "ntt_us": round(nl * 1e6, 1),
            }
            log(f"sweep n=2^{ln}: {o:.2f} ops/s (median {st['median']*1e3:.3f} ms), "
                f"NTT {nl*1e6:.0f} us")

    semantics = "batched_throughput; use latency_1ct_ms for round-over-round single-ct comparison"
    if device == "cuda":
        # the same op, batch and chain through the plain versions on this
        # machine's CPU; a plain call takes seconds, so the loop starts at
        # one call and takes BASELINE_WINDOWS windows
        p_cpu = FastParams.make(log_n, nlimb, zp=2, impl="vpu")
        ops_cpu, _, st_cpu = bench_on("cpu", p_cpu, np.random.default_rng(0), min(secs, 1.0),
                                      batch=batch, chain=chain, ks=ks,
                                      windows=BASELINE_WINDOWS, iters=1)
        log(f"mul_relin on cpu (plain versions, impl vpu): {ops_cpu:.2f} ops/s "
            f"({st_cpu['windows']} windows)")
        vs = ops_accel / ops_cpu
        semantics += (f"; vs_baseline: the plain versions on the host CPU (impl vpu), best of "
                      f"{st_cpu['windows']} windows")
    else:
        vs = 1.0        # the run is the CPU run
    log(f"kernel launches (wrappers; graph replays not counted): {json.dumps(launch_counts())}")

    rec = {
        "metric": f"bgv_mul_relin_ops_per_s_n2e{log_n}_L{nlimb}"
                  + ("_hybrid" if ks == "hybrid" else ""),
        "value": round(ops_accel, 3),
        "unit": "ops/s",
        "vs_baseline": round(vs, 3),
        "batch": batch,
        "value_semantics": semantics,
        "latency_1ct_ms": round(lat_1ct * 1e3, 4) if lat_1ct else None,
        "dispersion": {
            "ms_best": round(stats["best"] * 1e3, 4),
            "ms_median": round(stats["median"] * 1e3, 4),
            "ms_iqr": round(stats["iqr"] * 1e3, 4),
            "windows": stats["windows"],
        },
        "ntt_us_qd1": round(ntt_lat * 1e6, 1),
        "ntt_us_qd8": round(ntt_lat_b8 * 1e6, 1),
    }
    if sweep:
        rec["sweep"] = sweep
    ok = True
    # every CUDA kernel of the harness against its plain version on the
    # card, recorded with the numbers they guard (BENCH_NATIVE=0 skips)
    if os.environ.get("BENCH_NATIVE", "1") != "0" and device == "cuda":
        from alchemy_tpu_torch.scripts.verify_device import run_checks

        checks = run_checks(device)
        rec["native_kernel_checks"] = checks
        ok = checks["pass"]
        log(f"native kernel checks: {'PASS' if ok else 'FAIL ' + str(checks)}")
    rec["backend"] = backend(device)
    rec["card"] = card(device)
    print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
