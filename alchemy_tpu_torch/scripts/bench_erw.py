"""Error-rate observability at example scale — port of `scripts/bench_erw.py`.

ONE recorded run of the Tunnel example (or HomomRLWR) with the noise probe
at full tower size, through `jit_compile(..., noise_probe=)`: the per-op
error rates of the reference's ErrorRateWriter are outputs of the one CUDA
graph (the device-resident Garner-digit probe, `she/noise_probe.py`), read
back in one copy after the call. Arithmetic (`ERW_ONLY=arithmetic`, not in
the JAX script) is the small one. The workloads are built as in the JAX
script (messages from default_rng(1)); the rates equal the JAX script's at
the same seed. Knob as in the JAX script: ERW_ONLY (tunnel, the default |
homomrlwr).

    python -m alchemy_tpu_torch.scripts.bench_erw [--device cpu] [--out PATH]

Prints the JAX script's record (`workload`, `device`, `decrypt_pass`,
`keygen_compile_s`, `probe_build_lower_s` — the graph's build —,
`first_call_s`, `ms_per_run_with_probe`, `per_op_error_rates`, `note`) plus
`backend` and `card` on stdout, merges it by workload into
build/bench/bench_erw.json (or --out), and exits 1 when the decryption
differs from the plaintext evaluation.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch


def main(device: str | None = None, argv=None, out: str | None = None) -> int:
    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.bench import OUT_DIR, backend, card, run_args, sync, write_record
    from alchemy_tpu_torch.interp.jit_exec import jit_compile
    from alchemy_tpu_torch.scripts.bench_examples import build

    args = run_args("alchemy_tpu_torch.scripts.bench_erw", device, argv, out, writes=True)
    device, out = args.device, args.out
    which = os.environ.get("ERW_ONLY", "tunnel")
    bk = TorchBackend(device)
    t0 = time.perf_counter()
    w = build(which, bk, 1)
    sync(device)
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    jfn = jit_compile(w["compiled"], w["cts"], noise_probe=w["ctx"])
    sync(device)
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    res, rates = jfn(*w["cts"])
    sync(device)
    first_s = time.perf_counter() - t0
    # warm steady-state timing with the probe attached
    t0 = time.perf_counter()
    iters = 5
    for _ in range(iters):
        res, rates = jfn(*w["cts"])
    sync(device)
    per_ms = (time.perf_counter() - t0) / iters * 1e3

    ok = w["compiled"].decrypt(res).equals(w["want"])
    rec = {
        "workload": which,
        "device": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
        "decrypt_pass": bool(ok),
        "keygen_compile_s": round(build_s, 1),
        "probe_build_lower_s": round(compile_s, 1),
        "first_call_s": round(first_s, 1),
        "ms_per_run_with_probe": round(per_ms, 2),
        "per_op_error_rates": [{"op": lbl, "rate": float(r)} for lbl, r in rates],
        "note": ("per-op rates are outputs of the ONE CUDA graph of the program "
                 "(device-resident Garner-digit probe, she/noise_probe.py), read back in one "
                 "copy after the call: the reference's ErrorRateWriter log at full tower size"),
        "backend": backend(device),
        "card": card(device),
    }
    # merge: the record file holds one record per workload
    path = out or OUT_DIR / "bench_erw.json"
    merged = json.loads(open(path).read()) if os.path.exists(path) else {"workloads": {}}
    merged["workloads"][which] = rec
    write_record(merged, "bench_erw.json", out)
    print(json.dumps(rec, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
