"""The traced slice of a `--trace 1` run: a fixed number of the cell's own
calls under `torch.profiler` with CUDA activity alone (no CPU-side op
records, which would slow the host and inflate the device's idle time),
reduced to summaries in memory: no trace file is written.

The summary names each device operation by class: the port's own kernels
by their CUDA function names (`PORT_KERNELS`), every other kernel, copy or
set by a shortened name of its own (the torch ops of the program's glue).
"""

from __future__ import annotations

import re
import subprocess
import time

#: the port's kernels (classes) and the CUDA functions that are each
PORT_KERNELS = {
    "tensor_intt": re.compile(r"\btensor_intt_kernel\b"),
    "digit_relin": re.compile(r"\bdigit_relin_kernel\b"),
    "hybrid_digit_relin": re.compile(r"\bhybrid_digit_relin_kernel\b"),
    "intt_grid": re.compile(r"\bintt_grid_kernel\b"),
    "ntt_grid": re.compile(r"\bntt_grid_kernel\b"),
    "rescale_fwd": re.compile(r"\brescale_fwd_kernel\b"),
}
#: entries of each list in the result line's `breakdown`
TOP = 10


def label(name: str) -> tuple[str, bool]:
    """(the class or short name of a device operation, whether it is one of
    the port's kernels). A torch kernel is named by its template and the
    innermost functor or kernel function it was instantiated with, e.g.
    `vectorized_elementwise_kernel[remainder_kernel_cuda]`."""
    for cls, pat in PORT_KERNELS.items():
        if pat.search(name):
            return cls, True
    s = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    depth = 0
    for i, ch in enumerate(s):          # cut the parameter list, outside any template
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0:
            s = s[:i]
            break
    head, _, args = s.partition("<")
    base = head.split("::")[-1].strip()
    inner = re.findall(r"\w+Functor\w*|\w+_kernel_cuda|\w+_kernel_impl\w*", args)
    return (f"{base}[{inner[-1]}]" if inner else base or name.strip())[:96], False


def card_info() -> dict:
    """The card's name, power limit (W) and maximum SM clock (MHz), as
    nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True, check=True, timeout=60)
    name, power, clock = (f.strip() for f in out.stdout.splitlines()[0].split(","))
    return {"name": name, "power_limit_w": float(power), "clock_max_mhz": float(clock)}


def _device_events(prof) -> list[tuple[str, int, int]]:
    """(name, start ns, end ns) of every device operation the profiler saw."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA"):
            continue
        if hasattr(e, "start_ns"):
            start, dur = e.start_ns(), e.duration_ns()
        else:
            start, dur = int(e.start_us() * 1000), int(e.duration_us() * 1000)
        out.append((e.name(), start, start + dur))
    return sorted(out, key=lambda e: e[1])


def summarize(events: list[tuple[str, int, int]], window_s: float, calls: int) -> dict:
    """Busy time (the union of the operations' intervals), device seconds
    and counts by label, each port kernel's durations, the glue's seconds
    (every operation not a port kernel), and idle gaps by the operation that
    ends them."""
    by_label: dict[str, list] = {}
    durations: dict[str, list] = {}
    gaps: dict[str, float] = {}
    glue = busy = 0
    end = None
    for name, s, e in events:
        lab, port = label(name)
        entry = by_label.setdefault(lab, [0, 0])
        entry[0] += 1
        entry[1] += e - s
        if port:
            durations.setdefault(lab, []).append((e - s) * 1e-9)
        else:
            glue += e - s
        if end is None or s >= end:
            if end is not None and s > end:
                gaps[lab] = gaps.get(lab, 0) + (s - end) * 1e-9
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return {"calls": calls, "window_s": window_s, "busy_s": busy * 1e-9, "ops": len(events),
            "glue_s": glue * 1e-9, "durations": durations,
            "by_label": {k: {"count": c, "seconds": ns * 1e-9} for k, (c, ns) in by_label.items()},
            "gaps": gaps}


def breakdown(summary: dict) -> dict:
    """The result line's `breakdown`: the device operations that took most
    time, and the longest idle gaps by what the host was launching."""
    ops = sorted(summary["by_label"].items(), key=lambda kv: -kv[1]["seconds"])[:TOP]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[k, v["seconds"]] for k, v in ops],
            "idle_gaps": [[f"launch of {k}", v] for k, v in gaps]}


def profile_slice(call, first: int, calls: int, sync_each: bool, sync) -> dict:
    """Profile calls first .. first + calls - 1 (after one profiled call that
    starts the profiler's device tracing and is thrown away) and summarize
    them; the slice's wall time runs from its first call to the
    synchronize after its last."""
    import warnings

    from torch.profiler import ProfilerActivity, profile

    warnings.filterwarnings("ignore", message="Profiler clears events")
    with profile(activities=[ProfilerActivity.CUDA]):
        call(first)
        sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for k in range(first, first + calls):
            call(k)
            if sync_each:
                sync()
        sync()
        window_s = time.perf_counter() - t0
    return summarize(_device_events(prof), window_s, calls)
