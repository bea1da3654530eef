"""The level pipeline against the sequential chain — port of
`scripts/bench_pipeline.py`.

A depth-D mul+relin+rescale chain over M micro-batches (`parallel/
pipeline.py` `make_pipeline_chain`), pipelined over S stages against the
identical sequential chain in this process (`fast.mul_relin` + the padded
rescale on the whole batch), each the best of 3 windows of 3 calls:
  - S = 1 on a one-rank world in this process (NCCL on the card, gloo on
    the CPU), and S = PIPE_STAGES on a LocalWorld of that many rank
    processes: NCCL with `--cards` ≥ S (one rank a card), else gloo (on the
    CPU, or ranks sharing one card, every collective staged through host);
  - bit-identity of both with the sequential chain;
  - the bubble fraction (S−1)/(S+M−1) and the ideal utilization it implies;
  - the bytes each rank holds: its levels' hints and its share of the
    input (the counterpart of the JAX script's compiled argument bytes).
Knobs as in the JAX script: PIPE_DEPTH (16), PIPE_STAGES (4), PIPE_MICRO
(16), PIPE_LOG_N (7); one ciphertext a micro-batch, L0 = depth + 2 limbs,
seed 7, the FastParams default order ("mxu").

    python -m alchemy_tpu_torch.scripts.bench_pipeline [--device cpu] [--cards N] [--out PATH]

Prints the JAX script's record (`config`, `bit_identical_to_sequential`,
`measured`, `utilization_accounting`, `memory_residency`) plus `backend`
and `card` on stdout, writes it to build/bench/bench_pipeline.json or
--out, and exits 1 when a pipelined result differs from the sequential one.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import replace

import numpy as np
import torch


def timed(fn, arg, device, iters: int = 3):
    """(fn(arg), best s a call over 3 windows of `iters` calls, after one)."""
    from alchemy_tpu_torch.bench import _timed_loop, sync

    out = fn(arg)
    sync(device)
    return out, _timed_loop(lambda _: fn(arg), None, 0.0, 3, iters, device)[1]


def pipeline_inputs(depth: int, M: int, log_n: int, device: str) -> dict:
    """The JAX script's inputs from seed 7: params at L0 = depth + 2 limbs,
    padded hints [L0, L0, n] a level (raw, under the key at each level's
    chain), M ciphertexts [M, 2, L0, n]."""
    from alchemy_tpu_torch.she import fast
    from alchemy_tpu_torch.she.keys import gaussian_coeffs

    L0 = depth + 2
    p = fast.FastParams.make(log_n, L0, zp=2)
    rng = np.random.default_rng(7)
    s_int = gaussian_coeffs(rng, 1.0, p.n)

    def key_at(pp):
        return fast._ntt_p(pp, fast._residues(s_int, pp.qs, device))

    hints = []
    cur = p
    for level in range(depth):
        act = L0 - level
        hb, ha = fast.relin_hint(cur, key_at(cur), rng)
        pad = []
        for h in (hb, ha):
            full = torch.zeros((L0, L0, p.n), dtype=torch.int32, device=device)
            full[:act, :act] = h
            pad.append(full)
        hints.append(tuple(pad))
        cur = replace(cur, qs=cur.qs[:-1])
    msgs = [rng.integers(0, 2, p.n) for _ in range(M)]
    cts = torch.stack([fast.encrypt(p, key_at(p), m, rng) for m in msgs])
    return {"p": p, "hints": hints, "cts": cts}


def pipeline_rank(S: int, log_n: int, qs, impl: str, M: int, hints, cts, device: str):
    """A rank's side of the pipeline over the world's first S ranks (every
    rank calls it; the others return None): {"ms", "hint_bytes",
    "input_bytes", "out" (the last stage's result, on the CPU)}."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from alchemy_tpu_torch.bench import share_cpu
    from alchemy_tpu_torch.parallel.pipeline import make_pipeline_chain
    from alchemy_tpu_torch.she.fast import FastParams

    share_cpu(device)
    mesh = DeviceMesh(device, torch.arange(S), mesh_dim_names=("stage",))
    if mesh.get_coordinate() is None:
        return None
    p = FastParams(n=1 << log_n, qs=tuple(qs), zp=2, impl=impl)
    run = make_pipeline_chain(p, mesh, hints, mb=1, n_micro=M)
    x = distribute_tensor(cts.to(device), mesh, [Shard(0)], src_data_rank=None)
    out, t = timed(run, x, device)
    hb, ha, _ = run._hint_args
    last = mesh.get_local_rank() == S - 1
    return {"ms": t * 1e3, "hint_bytes": (hb.numel() + ha.numel()) * 4,
            "input_bytes": x.to_local().numel() * 4,
            "out": out.to_local()[0].cpu() if last else None}


def run(device: str, cards: int = 1, world=None) -> dict:
    """The record: S = 1 in this process, S = PIPE_STAGES on `world` (that
    many ranks) or on a LocalWorld started here."""
    import torch.distributed as dist

    from alchemy_tpu_torch.bench import backend, card, on_ranks, world_backend
    from alchemy_tpu_torch.parallel.multihost import init_multihost
    from alchemy_tpu_torch.parallel.pipeline import _level_consts, rescale_padded
    from alchemy_tpu_torch.she import fast

    depth = int(os.environ.get("PIPE_DEPTH", "16"))
    S = int(os.environ.get("PIPE_STAGES", "4"))
    M = int(os.environ.get("PIPE_MICRO", "16"))
    log_n = int(os.environ.get("PIPE_LOG_N", "7"))
    inp = pipeline_inputs(depth, M, log_n, device)
    p, hints, cts = inp["p"], inp["hints"], inp["cts"]
    L0 = len(p.qs)

    # the sequential reference: the same M ciphertexts through all D levels
    # in one batch on this process's device
    consts = [_level_consts(p, lvl) for lvl in range(depth)]

    def seq(x):
        for lvl in range(depth):
            hb, ha = hints[lvl]
            x = rescale_padded(p, fast.mul_relin(p, x, x, hb, ha), consts[lvl])
        return x

    out_seq, t_seq = timed(seq, cts, device)
    hints_cpu = [(hb.cpu(), ha.cpu()) for hb, ha in hints]
    args = (log_n, p.qs, p.impl, M, hints_cpu, cts.cpu(), device)
    own, threads = not dist.is_initialized(), torch.get_num_threads()
    init_multihost(backend="nccl" if device == "cuda" else "gloo")
    try:
        one = pipeline_rank(1, *args)
    finally:
        torch.set_num_threads(threads)
        if own:
            dist.destroy_process_group()
    transport = world.backend if world is not None else world_backend(device, cards, S)
    ranks = on_ranks(world, S, transport, pipeline_rank, S, *args)
    stages = [r for r in ranks if r is not None]
    t_pipe = max(r["ms"] for r in stages) / 1e3
    ref = out_seq.cpu()
    bitident = bool(torch.equal(one["out"], ref) and torch.equal(stages[-1]["out"], ref))

    hint_total = 2 * depth * L0 * L0 * p.n * 4
    input_total = M * 2 * L0 * p.n * 4
    ticks = S + M - 1
    return {
        "config": {"depth": depth, "stages": S, "micro_batches": M, "log_n": log_n, "L0": L0},
        "bit_identical_to_sequential": bitident,
        "measured": {
            "pipelined_ms_per_call": round(t_pipe * 1e3, 1),
            "pipelined_S1_ms_per_call": round(one["ms"], 1),
            "sequential_ms_per_call": round(t_seq * 1e3, 1),
            "ratio_pipe_over_seq": round(t_pipe / t_seq, 3),
            "note": (f"S = {S} on {S} rank processes over {transport} ({device}; ranks on "
                     "the CPU or sharing one card contend for it, so the ratio reflects "
                     "that); S = 1 on a one-rank world in the script's process; the slowest "
                     "rank's time"),
        },
        "utilization_accounting": {
            "ticks": ticks,
            "bubble_fraction": round((S - 1) / ticks, 4),
            "ideal_stage_utilization": round(M / ticks, 4),
            "ideal_speedup_vs_sequential": round(S * M / (S + M - 1), 3),
            "formula": "(S-1)/(S+M-1) bubbles; speedup = S*M/(S+M-1)",
        },
        "memory_residency": {
            "per_device_argument_bytes": max(r["hint_bytes"] + r["input_bytes"] for r in stages),
            "replicated_would_be_bytes": hint_total + input_total,
            "hint_total_bytes": hint_total,
            "input_total_bytes": input_total,
            "note": "a rank's own levels' hints and its micro-batches of the input "
                    "(~1/S each)",
        },
        "backend": backend(device),
        "card": card(device),
    }


def main(argv=None, device: str | None = None, out: str | None = None, world=None) -> int:
    from alchemy_tpu_torch.bench import log, run_args, write_record

    args = run_args("alchemy_tpu_torch.scripts.bench_pipeline", device, argv, out, writes=True,
                    cards=True)
    rec = run(args.device, args.cards, world=world)
    print(json.dumps(rec, indent=1))
    log(f"wrote {write_record(rec, 'bench_pipeline.json', args.out)}")
    return 0 if rec["bit_identical_to_sequential"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
