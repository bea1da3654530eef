"""Device-time breakdown and a floor for the shipped example workloads as
CUDA graphs — port of `scripts/profile_examples.py`.

For Tunnel and HomomRLWR (built as `scripts/bench_examples.py` builds them),
this script:
  1. prepares the whole program as one CUDA graph (`jit_compile`);
  2. counts the EXACT base MACs of every merged-axis CRT transform of one
     eager evaluation (`TorchBackend.mac_log`, the port's counterpart of
     the JAX `MAC_COUNTER`): L·d_out·d_in·R per matrix applied;
  3. profiles the replays' kernels (`scripts/profile_trace.device_profile`)
     and buckets them into compute and data movement (copies, fills,
     concatenations, gathers);
  4. states the floor of the transforms alone: the port's `axis_matmul`
     multiplies 16-bit halves in one float64 matmul of 4 float64 MACs per
     base MAC, at the H100 SXM's FP64 tensor-core peak of 67 TFLOP/s
     (33.5 TMAC/s, NVIDIA's data sheet, at its 700 W limit; the card's own
     name and limit are in `card`). The int64 elementwise work is not in the
     floor.
Arithmetic (`EXP_ONLY=arithmetic`) is the small one. Knobs as in the JAX
script: EXP_ITERS (30), EXP_ONLY (tunnel | homomrlwr; both by default).

    python -m alchemy_tpu_torch.scripts.profile_examples [--device cpu] [--out PATH]

Prints one JSON record a workload with the JAX script's keys (on the card
`mxu_floor_us` is the FP64 floor above) plus `backend` and `card`, and
writes {"workloads": [...]} to build/bench/profile_examples.json or --out.
On the CPU the breakdown is over the CPU's top-level ops.
"""

from __future__ import annotations

import json
import os
import sys
import time

#: float64 MACs of the port's axis_matmul per base MAC (16-bit halves of the
#: matrix times 16-bit halves of the residues: [2·d_out, K] @ [K, 2·R])
FP64_MACS_PER_BASE_MAC = 4
#: H100 SXM FP64 tensor-core peak, MAC/s (67 TFLOP/s, NVIDIA's data sheet)
FP64_MACS_PER_S = 33.5e12
#: substrings of the kernels that move data rather than compute
MOVE_KEYS = ("copy", "memcpy", "memset", "cat", "transpose", "slice", "index", "gather", "fill")


def profile_one(name: str, iters: int, device: str) -> dict:
    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.bench import backend, card, sync
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.interp.jit_exec import jit_compile
    from alchemy_tpu_torch.scripts.bench_examples import SEEDS, build
    from alchemy_tpu_torch.scripts.profile_trace import device_profile

    bk = TorchBackend(device)
    w = build(name, bk, SEEDS[name])
    bk.mac_log = []
    eval_ir(w["compiled"].ir, *w["cts"])
    macs_rec, bk.mac_log = bk.mac_log, None
    base_macs = sum(L * di * do * R for (L, di, do, R) in macs_rec)
    t0 = time.perf_counter()
    jfn = jit_compile(w["compiled"], w["cts"])
    jfn(*w["cts"])
    sync(device)
    compile_s = time.perf_counter() - t0

    prof = device_profile(lambda: jfn(*w["cts"]), (), iters, device)
    events = prof["events"]
    total_us = sum(t for _, t, _ in events) / iters
    move_us = sum(t for n, t, _ in events if any(k in n.lower() for k in MOVE_KEYS)) / iters
    floor_us = base_macs * FP64_MACS_PER_BASE_MAC / FP64_MACS_PER_S * 1e6
    top = [{"op": n[:80], "us_per_step": round(t / iters, 1),
            "count_per_step": round(c / iters, 1)} for n, t, c in events[:12]]
    return {
        "workload": name,
        "device_us_per_step": round(total_us, 1),
        "data_movement_us": round(move_us, 1),
        "compute_us": round(total_us - move_us, 1),
        "data_movement_pct": round(100 * move_us / total_us, 1),
        "device_ops_per_step": int(prof["launches"] / iters),
        "transform_groups_per_step": len(macs_rec),
        "exact_base_macs_per_step": int(base_macs),
        "mxu_floor_us": round(floor_us, 1),
        "floor_model": f"base_macs x {FP64_MACS_PER_BASE_MAC} float64 MACs at "
                       f"{FP64_MACS_PER_S / 1e12:.1f} TMAC/s (H100 SXM FP64 tensor-core peak)",
        "gap_to_floor": round(total_us / floor_us, 1) if floor_us else None,
        "trace_compile_s": round(compile_s, 1),
        "top_ops": top,
        "backend": backend(device),
        "card": card(device),
    }


def main(device: str | None = None, argv=None, out: str | None = None) -> int:
    from alchemy_tpu_torch.bench import log, run_args, write_record

    args = run_args("alchemy_tpu_torch.scripts.profile_examples", device, argv, out,
                    writes=True)
    device, out = args.device, args.out
    iters = int(os.environ.get("EXP_ITERS", "30"))
    only = os.environ.get("EXP_ONLY", "")
    recs = []
    for name in [only] if only else ["tunnel", "homomrlwr"]:
        recs.append(profile_one(name, iters, device))
        print(json.dumps(recs[-1], indent=1), flush=True)
    log(f"wrote {write_record({'workloads': recs}, 'profile_examples.json', out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
