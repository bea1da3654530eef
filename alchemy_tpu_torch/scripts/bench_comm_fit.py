"""The communication term of the scaling model on a real transport — port of
`scripts/bench_comm_fit.py`.

Two rank processes (`parallel.multihost.LocalWorld`) time an ISOLATED
`torch.distributed.all_to_all_single` across the process boundary at
several payload sizes (ROW_COUNTS rows of 2048 int32 words a rank), best of
5 windows, check the exchange once, and fit the affine model
t = bytes/BW + lat that `parallel/bench_scaling.predict_ici_efficiency`
uses, by relative-error weighted least squares, as the JAX script does.
The transport is NCCL between cards with `--cards 2` or more (tensors on
the cards), else gloo (tensors in host memory, gloo's own transport; on one
card the ranks share it and this is what the comm helpers stage through).

    python -m alchemy_tpu_torch.scripts.bench_comm_fit [--device cpu] [--cards N] [--out PATH]

Prints the JAX script's record (`setup`, `points`, `affine_fit`,
`interpretation`) plus `backend` and `card` on stdout and writes it to
build/bench/bench_comm_fit.json or --out.
"""

from __future__ import annotations

import json
import sys

import numpy as np

#: payload sizes: rows × 2048 int32 words a rank (bytes = rows·8192)
ROW_COUNTS = (8, 32, 128, 512, 2048)


def comm_rank(row_counts, device: str) -> list:
    """A rank's side: one point a payload size (rank 0's are the record's)."""
    import torch
    import torch.distributed as dist

    from alchemy_tpu_torch.bench import _timed_loop, share_cpu

    share_cpu(device)
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = device if dist.get_backend() == "nccl" else "cpu"
    results = []
    for rows in row_counts:
        base = torch.arange(rows * 2048, dtype=torch.int32).reshape(rows, 2048)
        x = (base + rank * rows * 2048).to(dev)
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x)
        # row block r of every rank's x, in rank order
        h = rows // world
        want = torch.cat([(base + j * rows * 2048)[rank * h:(rank + 1) * h]
                          for j in range(world)]).to(dev)
        if not torch.equal(out, want):
            raise RuntimeError(f"all_to_all_single at {rows} rows moved the wrong rows")
        iters = max(10, min(400, (1 << 22) // (rows * 8192)))
        best = _timed_loop(lambda _: dist.all_to_all_single(out, x), None, 0.0, 5, iters, dev)[1]
        # bytes crossing the boundary a rank: the half of the block that
        # goes to the peer ((C−1)/C with C = 2)
        results.append({"rows": rows, "bytes_crossing_per_device": rows * 2048 * 4 // 2,
                        "us_per_call": round(best * 1e6, 2), "iters": iters})
    return results


def affine_fit(results) -> dict:
    """t_us = bytes/BW + lat, minimizing the relative error (a plain lstsq
    lets the largest payload dominate)."""
    b = np.array([p["bytes_crossing_per_device"] for p in results], float)
    t = np.array([p["us_per_call"] for p in results], float)
    A = np.stack([b, np.ones_like(b)], axis=1)
    (inv_bw, lat), *_ = np.linalg.lstsq(A / t[:, None], np.ones_like(t), rcond=None)
    pred = A @ np.array([inv_bw, lat])
    resid = np.abs(pred - t) / t
    return {
        "model": "t_us = bytes_crossing / BW + lat (relative-error weighted least squares)",
        "BW_MBps": round(1.0 / inv_bw, 1) if inv_bw > 0 else None,
        "lat_us": round(float(lat), 1),
        "max_relative_residual": round(float(resid.max()), 3),
        "mean_relative_residual": round(float(resid.mean()), 3),
    }


def run(device: str, cards: int = 1, row_counts=None, world=None) -> dict:
    """The record at `row_counts` (default ROW_COUNTS), on `world` (two
    ranks) or a LocalWorld of two started here."""
    row_counts = row_counts or ROW_COUNTS
    from alchemy_tpu_torch.bench import backend, card, on_ranks, world_backend

    transport = world.backend if world is not None else world_backend(device, cards, 2)
    points = on_ranks(world, 2, transport, comm_rank, row_counts, device)[0]
    where = "the cards" if transport == "nccl" else "host memory"
    return {
        "setup": f"2 rank processes, torch.distributed {transport}, tensors in {where}, "
                 "isolated all_to_all_single across the process boundary, best-of-5 "
                 "windows per payload",
        "points": points,
        "affine_fit": affine_fit(points),
        "interpretation": (
            "whether the affine bytes/BW + lat form of the scaling model's communication "
            "term fits this transport's measured collective across the payload sizes, "
            "with this transport's constants"),
        "backend": backend(device),
        "card": card(device),
    }


def main(argv=None, device: str | None = None, out: str | None = None, world=None) -> int:
    from alchemy_tpu_torch.bench import log, run_args, write_record

    args = run_args("alchemy_tpu_torch.scripts.bench_comm_fit", device, argv, out, writes=True,
                    cards=True)
    rec = run(args.device, args.cards, world=world)
    print(json.dumps(rec, indent=1))
    log(f"wrote {write_record(rec, 'bench_comm_fit.json', args.out)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
