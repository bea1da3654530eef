"""One run of one cell of the benchmark of `alchemy_tpu_torch`:

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
In order: load the cell's configuration and traffic by name; build the
system under test from the seed (the port's kernels come from its fixed
cache `build/kernels/` in the checkout, built there by the first run);
warm up the cell's one shape; measure for --seconds, a closed loop of one
caller; with --trace 1, profile a fixed slice of further calls; read the
peak memory and free the program's state; judge the outputs kept from the
window against the plain reference; print one JSON line.

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics (each read by `metrics/<name>.py`). Without the cards the run
fails; it never falls back to the CPU. It exits 3 without a result if the
process has loaded JAX or the JAX package.
"""

import time

_T0 = time.perf_counter()    # set-up is timed from here, the run's first statement

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "alchemy_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic) of a cell, found by name."""
    cell = load("workloads", name)
    return cell, load("configs", cell["config"]), load("traffic", cell["traffic"])


def readers() -> dict:
    """{metric name: module} of every per-layer reader in metrics/."""
    out = {}
    for path in sorted((HERE / "metrics").glob("*.py")):
        spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{path.stem}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[path.stem] = mod
    return out


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def window(call, traffic: dict, seconds: float, seed: int, sync) -> dict:
    """Calls k = 0, 1, ... back to back until `seconds` have passed, then a
    synchronize. With traffic["sync_each_call"] each call ends in a
    synchronize and its latency is kept. A uniform sample (reservoir, drawn
    from the seed) of traffic["kept_calls"] outputs is kept for the judge."""
    pick = random.Random(f"{seed}/kept")
    keep, each = traffic["kept_calls"], traffic["sync_each_call"]
    kept: list = []
    host, latency, errors = [], [], []
    failed = k = 0
    sync()
    start = time.perf_counter()
    stop_at = start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= stop_at:
            break
        try:
            out = call(k)
        except Exception:     # a call that raises is a failed call; the window goes on
            out = None
            if len(errors) < 3:
                errors.append(traceback.format_exc())
        t1 = time.perf_counter()
        if each:
            sync()
            latency.append(time.perf_counter() - t0)
        host.append(t1 - t0)
        if out is None:
            failed += 1
        elif len(kept) < keep:
            kept.append((k, out))
        else:
            j = pick.randrange(k + 1)
            if j < keep:
                kept[j] = (k, out)
        k += 1
    sync()
    return {"calls": k, "failed": failed, "seconds": time.perf_counter() - start,
            "host_s": host, "latency_s": latency, "kept": dict(kept), "errors": errors}


def end_to_end(win: dict, traffic: dict, setup_s: float) -> dict:
    """The end-to-end metrics the traffic names, with setup_s."""
    import numpy as np

    done = win["calls"] - win["failed"]
    values = {"ct_mul_per_s": (done * traffic["batch"] / win["seconds"], "ops/s")}
    if win["latency_s"]:
        values["call_p95_ms"] = (float(np.percentile(win["latency_s"], 95)) * 1e3, "ms")
    out = {"setup_s": {"value": setup_s, "unit": "s"}}
    for name in traffic["end_to_end"]:
        value, unit = values[name]
        out[name] = {"value": value, "unit": unit}
    return out


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t0: float | None = None) -> dict:
    """One run of a configuration under a traffic mix; returns the result
    (the keys of the printed line, and `checks` with each number compared,
    its value and its limit)."""
    import torch

    from benchmark import trace as tracing

    if traffic["loop"] != "closed" or traffic["callers"] != 1:
        raise ValueError(f"traffic {traffic}: the generator drives one closed-loop caller")
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter() if t0 is None else t0
    t_torch = time.perf_counter()
    system_mod = importlib.import_module(f"benchmark.systems.{cfg['system']}")
    log(f"[setup] torch imported at {t_torch - t0:.3f} s, the system's modules at "
        f"{time.perf_counter() - t0:.3f} s")
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    system = system_mod.System(cfg, traffic, seed, dev)
    t_built = time.perf_counter()
    for k in range(traffic["warmup_calls"]):
        system.call(k)
    sync()
    setup_s = time.perf_counter() - t0
    log(f"[setup] {setup_s:.3f} s: system {t_built - t0:.3f} s, warm-up "
        f"{traffic['warmup_calls']} calls {time.perf_counter() - t_built:.3f} s")
    win = window(system.call, traffic, seconds, seed, sync)
    for err in win["errors"]:
        log(err)
    log(f"[window] {win['calls']} calls, {win['failed']} failed, {win['seconds']:.3f} s; host "
        f"span per call median {statistics.median(win['host_s']) * 1e3:.4f} ms"
        if win["host_s"] else "[window] no call")
    summary = card = None
    if trace:
        summary = tracing.profile_slice(system.call, win["calls"], traffic["trace_calls"],
                                        traffic["sync_each_call"], sync)
        card = tracing.card_info() if cuda else None
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    system.close()
    del system
    t_judge = time.perf_counter()
    checks = system_mod.judge(cfg, traffic, seed, win["kept"], dev)
    compared = checks.pop("compared_calls")
    log(f"[judge] {compared} calls against the reference in {time.perf_counter() - t_judge:.3f} s")
    correct = (win["failed"] == 0 and compared > 0
               and all(v <= cfg["limits"][k] for k, v in checks.items()))
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": win["calls"], "failed": win["failed"]}
    if trace:
        ctx = {"cfg": cfg, "traffic": traffic, "trace": summary, "window": win, "card": card,
               "notes": {}}
        metrics = {}
        for name, mod in readers().items():
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": mod.UNIT}
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result.update(metrics=metrics, device=device_info, breakdown=tracing.breakdown(summary),
                      card=card, notes=ctx["notes"])
    else:
        result.update(metrics=end_to_end(win, traffic, setup_s), device=device_info)
    result["compared_calls"] = compared
    result["checks"] = {k: {"value": v, "limit": cfg["limits"][k]} for k, v in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, cfg, traffic = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload}: needs {cell['chips']} CUDA device(s), found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run(cfg, traffic, args.seed, args.seconds, bool(args.trace), "cuda", _T0)
    bad = forbidden_modules()
    if bad:
        log(f"the run loaded {bad}: the benchmark may load neither JAX nor the JAX package")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
