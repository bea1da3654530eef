"""The readings the limits of `correct` are set from, and the runs that show
they catch a wrong program: whole runs of a cell (set-up, a short window,
the judge) on many seeds in one process, with the port's entry as it is
("program"), with the control in its place ("control": the reference with
its modular products rounded to float64, the precision below the exact
64-bit products the configuration states), or with the entry broken
underneath (`FAULTS`).

    python -m benchmark.readings --workload <cell> --seconds 2 --seeds 1 2 3 \
        [--control-seeds 4 5 6] [--faults unchanged altered]

prints one JSON line per run: the side, the seed, `correct`, each number
compared and the end-to-end metrics. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import reference
from benchmark.run import load_cell, run


def _values(h):
    """The values of a hint (raw, or a Shoup pair)."""
    h = h[0] if isinstance(h, (tuple, list)) else h
    return h.to(torch.int64) & 0xFFFFFFFF


def control_entry(cfg: dict, device):
    """The reference in float64 products, with the signature of the port's
    entry: (params, ct_a, ct_b, hint_b, hint_a) → [batch, 2, L, n] int32."""
    mul = reference.float64_mul
    ring = reference.Ring(cfg["n"], cfg["qs"], cfg["order"], device, mul)
    ring_ext = (reference.Ring(cfg["n"], cfg["qs"] + cfg["special_primes"], cfg["order"], device,
                               mul) if cfg["key_switching"] == "hybrid" else None)

    def entry(_params, ct_a, ct_b, hint_b, hint_a):
        a, b = (t.to(torch.int64) & 0xFFFFFFFF for t in (ct_a, ct_b))
        hb, ha = _values(hint_b), _values(hint_a)
        if ring_ext is None:
            out = reference.mul_relin_trivgad(ring, a, b, hb, ha)
        else:
            out = reference.mul_relin_hybrid(ring, ring_ext, cfg["dnum"], cfg["zp"], a, b, hb, ha)
        return out.to(torch.int32)
    return entry


def _unchanged(entry):
    """A call that returns its first operand unchanged."""
    return lambda params, ct_a, ct_b, hb, ha: ct_a.clone()


def _half_batch(entry):
    """Half of the batch left out: its rows come back zero."""
    def f(params, ct_a, ct_b, hb, ha):
        out = entry(params, ct_a, ct_b, hb, ha).clone()
        out[out.shape[0] // 2:] = 0
        return out
    return f


def _altered(entry):
    """One residue of every answer altered where it is produced."""
    def f(params, ct_a, ct_b, hb, ha):
        out = entry(params, ct_a, ct_b, hb, ha).clone()
        out.view(-1)[0] = 0 if int(out.view(-1)[0]) else 1
        return out
    return f


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch, "altered": _altered}


@contextlib.contextmanager
def entry_replaced(cfg: dict, make):
    """The port's entry for cfg replaced by make(entry) for the block."""
    from alchemy_tpu_torch.she import fast, hybrid

    mod, name = ((hybrid, "mul_relin_hybrid") if cfg["key_switching"] == "hybrid"
                 else (fast, "mul_relin"))
    entry = getattr(mod, name)
    setattr(mod, name, make(entry))
    try:
        yield
    finally:
        setattr(mod, name, entry)


def reading(side: str, cfg: dict, traffic: dict, seed: int, seconds: float, device: str) -> dict:
    res = run(cfg, traffic, seed, seconds, False, device)
    return {"side": side, "seed": seed, "correct": res["correct"],
            "attempted": res["attempted"], "compared_calls": res["compared_calls"],
            "checks": {k: v["value"] for k, v in res["checks"].items()},
            "metrics": {k: v["value"] for k, v in res["metrics"].items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[], choices=sorted(FAULTS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cfg, traffic = load_cell(args.workload)
    runs = [("program", s, None) for s in args.seeds]
    runs += [("control", s, lambda _e: control_entry(cfg, args.device))
             for s in args.control_seeds]
    runs += [(f"fault:{f}", s, FAULTS[f]) for f in args.faults for s in args.seeds[:1]]
    for side, seed, make in runs:
        ctx = entry_replaced(cfg, make) if make else contextlib.nullcontext()
        with ctx:
            line = reading(side, cfg, traffic, seed, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
