"""The general path in a `--trace 1` run (configurations with `tower_ct`):
the device operations of the traced slice by kernel class, and the calls of
a compiled program (`interp.jit_exec.JitCompiled`, root span `jit_call`)
read from the port's span buffer as `spans.py` reads the product entries.
A program without those spans gives nothing.

Kernel classes, by the label `trace.label` gives an operation: "gemm", the
float64 GEMMs `TorchBackend._matmul_mod` launches (cuBLAS and CUTLASS
kernels: gemm, gemv, xmma, cutlass, splitKreduce, CUTLASS's `Kernel` and
`Kernel2` wrappers); "modq", torch's elementwise, reduction, copy and cat
kernels and the copies and sets between them (the int64 mod-q chains);
"other", the rest."""

from __future__ import annotations

import re

from benchmark import spans

#: the root span of a compiled program's call
ROOT = "jit_call"
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|splitKreduce|^Kernel2?$", re.I)
MODQ = re.compile(r"elementwise|reduce|CatArray|copy|Memcpy|Memset", re.I)


def kernel_class(label: str) -> str:
    """"gemm", "modq" or "other" of a device operation's label."""
    if GEMM.search(label):
        return "gemm"
    return "modq" if MODQ.search(label) else "other"


def share(ctx: dict, cls: str) -> float | None:
    """The device time of one kernel class over the slice's busy time (%),
    in configurations of the general path."""
    tr = ctx["trace"]
    if tr is None or "tower_ct" not in ctx["cfg"] or tr["busy_s"] <= 0:
        return None
    seconds = sum(v["seconds"] for label, v in tr["by_label"].items()
                  if kernel_class(label) == cls)
    return 100.0 * seconds / tr["busy_s"]


def slice_calls(ctx: dict) -> list[list] | None:
    """The spans of each of the traced slice's calls, root first: the last
    ctx["trace"]["calls"] finished `jit_call` roots whose output ring is the
    configuration's last ciphertext ring and whose argument has its
    `arg_limbs`, each with the spans of its call. None without a trace,
    outside the general path, or where the buffer holds fewer such roots."""
    tr, cfg = ctx["trace"], ctx["cfg"]
    if tr is None or "tower_ct" not in cfg or tr["calls"] <= 0:
        return None
    buf = spans._buffer()
    if buf is None:
        return None
    shape = {"m": cfg["tower_ct"][-1], "L": cfg["arg_limbs"]}
    roots = [s for s in buf if s.parent is None and s.name == ROOT and s.end_ns is not None
             and all(s.attrs.get(k) == v for k, v in shape.items())]
    if len(roots) < tr["calls"]:
        return None
    calls = {r.index: [r] for r in roots[-tr["calls"]:]}
    for s in buf:
        if s.parent is not None and s.call in calls:
            calls[s.call].append(s)
    return list(calls.values())
