"""Profile TrivGad multiply + relinearize on the card: over a steady window
of calls, the device's busy time and idle share and its time by kernel
(torch.profiler, CUPTI), beside the host clock.

    python -m alchemy_tpu_torch.examples.profile_mul_relin --log-n 16 15

At L = 8 limbs, Bt = 16 ciphertexts per call and Shoup hints (the
headline and ring-sweep configurations), 20 profiled calls. Prints the
card's name and power limit, then one JSON object per ring size. Needs a
CUDA device: without one it fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch

from alchemy_tpu_torch.she import fast


def _busy_us(spans: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def profile(log_n: int, L: int, Bt: int, calls: int, seed: int = 0) -> dict:
    """Keys, Shoup hints and 2·Bt fresh ciphertexts from `seed`, three
    warm-up calls, then `calls` calls of `fast.mul_relin` on Bt ciphertexts
    under the profiler."""
    p = fast.FastParams.make(log_n, L, zp=2)
    rng = np.random.default_rng(seed)
    s = fast.keygen(p, rng, device="cuda")
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(2 * Bt)])
    a, b = cts[:Bt], cts[Bt:]
    for _ in range(3):
        fast.mul_relin(p, a, b, hb, ha)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fast.mul_relin(p, a, b, hb, ha)
        torch.cuda.synchronize()
        host_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise RuntimeError("the profiler saw no device time")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    span = max(b for _, b in spans) - min(a for a, _ in spans)
    busy = _busy_us(spans)
    by_kernel = defaultdict(float)
    for e in kernels:
        by_kernel[e.name] += e.time_range.end - e.time_range.start
    return {"log_n": log_n, "L": L, "Bt": Bt, "calls": calls, "host_us": host_us,
            "device_span_us": span, "device_busy_us": busy, "idle_share": 1 - busy / span,
            "device_events": len(kernels), "host_ops_per_s": Bt * calls / host_us * 1e6,
            "by_kernel_us": dict(sorted(by_kernel.items(), key=lambda kv: -kv[1]))}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, nargs="+", default=[16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_mul_relin: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for log_n in args.log_n:
        print(json.dumps(profile(log_n, L=8, Bt=16, calls=20)), flush=True)


if __name__ == "__main__":
    main()
