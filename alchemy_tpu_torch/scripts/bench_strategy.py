"""The dist NTT's transpose strategies, a2a against the ring, across a real
process boundary — port of `scripts/bench_strategy.py`.

Two rank processes (`parallel.multihost.LocalWorld`) with the 'coeff' axis
of the mesh (1, 1, 2) spanning them time the forward distributed NTT
(`parallel.dist.make_dist_ntt`) of [4, 4, n] under both strategies, best of
3 windows, at n = 2^12 (40 calls a window) and 2^14 (20), as the JAX script.
The transport is NCCL with `--cards 2` or more (one rank a card), else gloo:
on the CPU (`--device cpu`), or two ranks sharing one card, where the comm
helpers stage every collective through host memory. `pick_dist_strategy`
keeps its default ("a2a"): this records the port's own reading.

    python -m alchemy_tpu_torch.scripts.bench_strategy [--device cpu] [--cards N] [--out PATH]

Prints the JAX script's record (`setup`, `results_ms_per_call`,
`ring_over_a2a_n2e12`, `ring_over_a2a_n2e14`) plus `backend` and `card` on
stdout and writes it to build/bench/bench_strategy.json or --out.
"""

from __future__ import annotations

import json
import sys

import numpy as np

#: (log2 n, limbs, calls a window) of the JAX script
SIZES = ((12, 4, 40), (14, 4, 20))


def strategy_rank(sizes, device: str) -> dict:
    """A rank's side: {"n2e{log_n}_L{nlimb}_{strategy}_ms": best ms a call}."""
    from torch.distributed.tensor import distribute_tensor

    from alchemy_tpu_torch.bench import _timed_loop, share_cpu, sync
    from alchemy_tpu_torch.convert import to_torch
    from alchemy_tpu_torch.parallel import dist as D
    from alchemy_tpu_torch.parallel.dist import DistConfig, make_dist_ntt
    from alchemy_tpu_torch.parallel.mesh import make_mesh
    from alchemy_tpu_torch.she.fast import FastParams

    share_cpu(device)
    mesh = make_mesh((1, 1, 2), device)
    results = {}
    for log_n, nlimb, iters in sizes:
        p = FastParams.make(log_n, nlimb, zp=2)
        n1 = 64
        cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
        rng = np.random.default_rng(0)
        x = np.stack([np.stack([rng.integers(0, q, p.n) for q in p.qs])
                      for _ in range(4)]).astype(np.uint32)
        xg = distribute_tensor(to_torch(x, device), mesh, D.NTT_PLACEMENTS, src_data_rank=None)
        for strat in ("a2a", "ring"):
            fwd, _ = make_dist_ntt(cfg, mesh, strategy=strat)
            y = fwd(xg)
            sync(device)
            best = _timed_loop(fwd, y, 0.0, 3, iters, device)[1]
            results[f"n2e{log_n}_L{nlimb}_{strat}_ms"] = round(best * 1e3, 3)
    return results


def run(device: str, cards: int = 1, sizes=None, world=None) -> dict:
    """The record at `sizes` (default SIZES), on `world` (two ranks) or a
    LocalWorld of two started here."""
    sizes = sizes or SIZES
    from alchemy_tpu_torch.bench import backend, card, on_ranks, world_backend

    transport = world.backend if world is not None else world_backend(device, cards, 2)
    results = on_ranks(world, 2, transport, strategy_rank, sizes, device)[0]
    rec = {
        "setup": f"2 rank processes, torch.distributed {transport} on {device}, 'coeff' axis "
                 "spanning the process boundary; forward distributed 4-step NTT of [4, 4, n], "
                 "best-of-3 windows, rank 0's times",
        "results_ms_per_call": results,
    }
    for log_n, nlimb, _ in sizes:
        a = results[f"n2e{log_n}_L{nlimb}_a2a_ms"]
        r = results[f"n2e{log_n}_L{nlimb}_ring_ms"]
        rec[f"ring_over_a2a_n2e{log_n}"] = round(r / a, 3)
    rec["backend"] = backend(device)
    rec["card"] = card(device)
    return rec


def main(argv=None, device: str | None = None, out: str | None = None, world=None) -> int:
    from alchemy_tpu_torch.bench import log, run_args, write_record

    args = run_args("alchemy_tpu_torch.scripts.bench_strategy", device, argv, out, writes=True,
                    cards=True)
    rec = run(args.device, args.cards, world=world)
    print(json.dumps(rec, indent=1))
    log(f"wrote {write_record(rec, 'bench_strategy.json', args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
