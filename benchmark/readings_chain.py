"""The control of a chain cell: whole runs of the cell (set-up, a short
window, the judge) with the port's chain entry replaced by the plain
reference's chain (`reference_chain.Chain`) in float64 products, the
precision below the exact 64-bit products the configuration states.
`readings.control_entry` replaces a single product; the chain's control
replaces the whole chain, its key and hints worked out in float64 too.
The program's own runs and the faults are `benchmark.readings`'s.

    python -m benchmark.readings_chain --workload deep16.chain --seconds 2 --control-seeds 4 5

prints one JSON line per run, as `benchmark.readings` does. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch

from benchmark import reference, reference_chain
from benchmark.readings import reading
from benchmark.run import load_cell


def control_chain(cfg: dict, seed: int, device):
    """The reference's chain in float64 products, with the signature of the
    port's chain entry: (levels, ct [..., 2, L, n]) → [..., 2, L − depth, n]
    int32. The levels the port made are not read."""
    chain = reference_chain.Chain(cfg, seed, device, reference.float64_mul)

    def entry(_levels, ct):
        x = (ct.to(torch.int64) & 0xFFFFFFFF).reshape(-1, *ct.shape[-3:])
        out = chain.run(x)
        return out.reshape(*ct.shape[:-2], *out.shape[-2:]).to(torch.int32)
    return entry


@contextlib.contextmanager
def chain_replaced(make):
    """The port's chain entry replaced by make(entry) for the block."""
    from alchemy_tpu_torch.examples import deep_circuit

    entry = deep_circuit.square_chain
    deep_circuit.square_chain = make(entry)
    try:
        yield
    finally:
        deep_circuit.square_chain = entry


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control-seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, cfg, traffic = load_cell(args.workload)
    for seed in args.control_seeds:
        with chain_replaced(lambda _e: control_chain(cfg, seed, args.device)):
            line = reading("control", cfg, traffic, seed, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, **line}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
