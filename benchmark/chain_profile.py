"""Where a chain cell's time goes, level by level: the cell's system built from
the seed, a few warm chains, then `--calls` chains (a synchronize after each)
under `torch.profiler` with CUDA activity alone, split by level. On the
device, each port kernel's and the other operations' mean time a chain, by
the level's L (a level runs from its kernel A to the next: A, `garner_pack`,
4, 9 and 7 of the product, then 9, the rescale's torch ops and 8). On the
host, the mean `chain.level` and `glue.rescale` spans by L. Then kernel 4 of
the level at `--warm-L` run `--calls` times on one ciphertext, its hint warm
in the L2, against its time inside the chains, where every level's hint is
read once a chain.

    python -m benchmark.chain_profile --workload deep16.chain --seed <n> [--calls 20]

prints one JSON line. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import torch


def by_level(events: list, depth: int, calls: int) -> list[dict]:
    """{class: device ms a chain} of each level, from the slice's device
    operations in start order; the rescale's torch ops (after a level's
    second inverse transform) are "rescale_glue", other non-port
    operations by their label."""
    from benchmark import trace

    levels: list[dict] = [{} for _ in range(depth)]
    level, inverses = -1, 0
    for name, s, e in events:
        label, port = trace.label(name)
        if label == "tensor_intt":
            level, inverses = (level + 1) % depth, 0
        if level < 0:
            continue
        inverses += label == "intt_grid"
        key = label if port or inverses < 2 else "rescale_glue"
        levels[level][key] = levels[level].get(key, 0.0) + (e - s) * 1e-6 / calls
    return levels


def main(argv=None) -> int:
    from alchemy_tpu_torch.examples import deep_circuit
    from alchemy_tpu_torch.she import hybrid
    from alchemy_tpu_torch.utils import profiling
    from benchmark import trace
    from benchmark.run import load_cell
    from benchmark.systems.bgv_square_chain import System
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="deep16.chain")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--warm-L", type=int, default=16)
    args = ap.parse_args(argv)
    _, cfg, traffic = load_cell(args.workload)
    dev = torch.device("cuda")
    system = System(cfg, traffic, args.seed, dev)
    for k in range(3):
        system.call(k)
    torch.cuda.synchronize(dev)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(args.calls):
            system.call(k)
            torch.cuda.synchronize(dev)
    levels = by_level(trace._device_events(prof), cfg["depth"], args.calls)
    spans = profiling.spans()
    by_index = {s.index: s for s in spans}
    host: dict[tuple, list] = {}
    for s in spans:
        if s.name in ("chain.level", "mul_relin_hybrid"):
            host.setdefault((s.name, s.attrs["L"]), []).append(s.duration_ns / 1e6)
        elif s.name == "glue.rescale":
            L = by_index[s.parent].attrs["L"]
            host.setdefault((s.name, L), []).append(s.duration_ns / 1e6)
    rows = []
    for i, lv in enumerate(cfg["levels"]):
        L = lv["L"]
        rows.append({"L": L, "dnum": lv["dnum"], "K": len(lv["special_primes"]),
                     "device_ms": {k: round(v, 5) for k, v in sorted(levels[i].items())},
                     "device_total_ms": round(sum(levels[i].values()), 5),
                     "host_level_ms": statistics.mean(host[("chain.level", L)]),
                     "host_product_ms": statistics.mean(host[("mul_relin_hybrid", L)]),
                     "host_rescale_glue_ms": statistics.mean(host[("glue.rescale", L)])})
    # kernel 4 at one level, on one ciphertext, its hint warm in the L2
    i = next(j for j, lv in enumerate(cfg["levels"]) if lv["L"] == args.warm_L)
    ct = system.pool[0]
    for j, lv in enumerate(system.levels[:i]):
        ct = deep_circuit.square_level(j, lv, ct)
    lv = system.levels[i]
    for _ in range(3):
        hybrid.mul_relin_hybrid(lv.hk, ct, ct, *lv.hints)
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(args.calls):
            hybrid.mul_relin_hybrid(lv.hk, ct, ct, *lv.hints)
            torch.cuda.synchronize(dev)
    warm = trace.summarize(trace._device_events(prof), 1.0, args.calls)["durations"]
    print(json.dumps({
        "workload": args.workload, "seed": args.seed, "calls": args.calls,
        "card": trace.card_info(), "levels": rows,
        "device_ms_a_chain": sum(r["device_total_ms"] for r in rows),
        "rescale_glue_device_ms_a_chain": sum(r["device_ms"].get("rescale_glue", 0)
                                              for r in rows),
        "warm_L2": {"L": args.warm_L, "ms": {k: statistics.mean(v) * 1e3
                                             for k, v in warm.items()},
                    "in_chain_ms": rows[i]["device_ms"]}}), flush=True)
    system.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
