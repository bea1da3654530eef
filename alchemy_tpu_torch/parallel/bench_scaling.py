"""Scaling harness of the distributed NTT — port of
`alchemy_tpu/parallel/bench_scaling.py` on `torch.distributed`.

The "devices" are the ranks of the running world (`parallel/multihost`):
every function here is called on every rank. A point with fewer mesh
positions than ranks runs on the first ranks (a `DeviceMesh` over a
subset); the others wait, and the point's time is the slowest rank's. On
gloo ranks on the CPU (or sharing one card) this validates the harness and
the communication pattern, not the interconnect.

The analytic predictions (`predict_*`) are pure arithmetic, the JAX
package's. They need two anchors, the single-device time of a transform
and of a mul+relin: no TPU figure is carried over. `sweep` measures them
on the card (the standalone NTT of [b, 8, 2^15] and [b, 8, 2^16], and
`fast.mul_relin`'s µs per ciphertext at n = 2^15, L = 8, 16 ciphertexts)
unless the caller passes them in; the link bandwidths are arguments.

`python -m alchemy_tpu_torch.parallel.bench_scaling` prints one JSON dict to
stdout (a one-rank world on the card; `--device cpu` for the CPU) and
writes no file.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import subprocess
import time
from math import prod

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import distribute_tensor

from alchemy_tpu_torch.convert import to_torch
from alchemy_tpu_torch.parallel import dist as D
from alchemy_tpu_torch.parallel.dist import DistConfig, make_dist_ntt
from alchemy_tpu_torch.parallel.mesh import AXES, check_device_type
from alchemy_tpu_torch.she.fast import FastParams

#: link bandwidths of the predictions, GB/s per rank and direction
BANDWIDTHS = (50.0, 100.0, 200.0)
_MESHES: dict = {}


def _mesh(shape: tuple, device_type: str) -> DeviceMesh:
    """The ('batch', 'limb', 'coeff') mesh of `shape` over the first
    prod(shape) ranks of the world (made once per shape, on every rank)."""
    key = (tuple(shape), device_type)
    if key not in _MESHES:
        check_device_type(device_type)
        _MESHES[key] = DeviceMesh(device_type, torch.arange(prod(shape)).reshape(shape),
                                  mesh_dim_names=AXES)
    return _MESHES[key]


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()


def _slowest(dt):
    """The largest of the ranks' times (None from ranks off the mesh)."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, dt)
    return max(t for t in got if t is not None)


def measure_dist_ntt(log_n: int = 12, nlimb: int = 4, coeff_shards: int = 2,
                     batch: int = 2, iters: int = 20, strategy: str | None = None,
                     device_type: str = "cuda"):
    """Returns (seconds_per_call, mesh_shape) for the sharded forward NTT
    (bench_scaling.py:25): 'coeff' scales, 'batch' stays 1 and 'limb' takes
    one factor of 2 when the ranks allow."""
    n_dev = dist.get_world_size()
    limb = 2 if (2 * coeff_shards <= n_dev and nlimb % 2 == 0) else 1
    shape = (1, limb, min(coeff_shards, n_dev))
    mesh = _mesh(shape, device_type)
    dt = None
    if mesh.get_coordinate() is not None:
        p = FastParams.make(log_n, nlimb, impl="vpu")
        n1 = 1 << (log_n // 2)
        cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)
        fwd, _ = make_dist_ntt(cfg, mesh, strategy=strategy)
        rng = np.random.default_rng(0)
        x = np.stack([np.stack([rng.integers(0, q, p.n) for q in p.qs])
                      for _ in range(batch)]).astype(np.uint32)
        y = fwd(distribute_tensor(to_torch(x, device_type), mesh, D.NTT_PLACEMENTS,
                                  src_data_rank=None))
        _sync(device_type)
        t0 = time.perf_counter()
        for _ in range(iters):
            y = fwd(y)
        _sync(device_type)
        dt = (time.perf_counter() - t0) / iters
    return _slowest(dt), shape


def measure_comm_split(log_n: int, nlimb: int, coeff_shards: int, batch: int = 2,
                       iters: int = 20, device_type: str = "cuda"):
    """The transpose's cost on this transport (bench_scaling.py:52): the
    full dist NTT, and a variant whose all_to_all is the shape-identical
    LOCAL chunk permutation (wrong values, no communication; measurement
    only), registered in DIST_STRATEGIES for the call and removed after."""

    def _a2a_local(x, axis_split, axis_concat, n_shards, mesh):
        return torch.cat(torch.chunk(x, n_shards, dim=axis_split), dim=axis_concat)

    full, _ = measure_dist_ntt(log_n, nlimb, coeff_shards, batch, iters, "a2a", device_type)
    D.DIST_STRATEGIES["__local__"] = _a2a_local
    try:
        local, _ = measure_dist_ntt(log_n, nlimb, coeff_shards, batch, iters, "__local__",
                                    device_type)
    finally:
        del D.DIST_STRATEGIES["__local__"]
    return full, local


def predict_ici_efficiency(log_n: int, nlimb: int, coeff_shards: int,
                           batch: int, t1_us: float, bw_GBps: float,
                           lat_us: float = 1.0) -> dict:
    """Analytic strong-scaling model for the a2a distributed NTT
    (bench_scaling.py:77): per device and call,

      bytes_ici = batch · L_loc · (n/C) · 4 B · (C−1)/C   (the ONE tiled
                  all_to_all; every other stage is local)
      T_comm    = bytes_ici / BW + lat
      T_comp    = t1_us / C     (t1_us: single-device time of the same
                  batch·L·n transform)
      efficiency = T_comp / (T_comp + T_comm)

    BW is the per-device link bandwidth usable by the all_to_all in one
    direction; lat the dispatch/barrier cost."""
    n = 1 << log_n
    C = coeff_shards
    bytes_ici = batch * nlimb * (n // C) * 4 * (C - 1) / C
    t_comm = bytes_ici / (bw_GBps * 1e3) + lat_us   # GB/s = 1e3 B/us
    t_comp = t1_us / C
    return {
        "coeff_shards": C,
        "bytes_ici_per_device": int(bytes_ici),
        "t_comp_us": round(t_comp, 2),
        "t_comm_us": round(t_comm, 2),
        "efficiency": round(t_comp / (t_comp + t_comm), 3),
    }


def predict_full_op_efficiency(log_n: int, nlimb: int, coeff_shards: int,
                               limb_shards: int, batch: int, t1_op_us: float,
                               bw_GBps: float, lat_us: float = 1.0,
                               digit_mac_fraction: float = 0.84) -> dict:
    """Analytic strong-scaling model for the full distributed ciphertext
    mult+relin (bench_scaling.py:107): the collectives of
    make_dist_mul_relin (digit hint placement, a2a strategy) per call:
      1 inverse-NTT a2a of c2        : B·L_loc·(n/C)·4·(C−1)/C bytes
      1 all_gather of c2 rows (limb) : B·(L−L_loc)·(n/C)·4 bytes received
      L digit-NTT a2as               : L·B·L_loc·(n/C)·4·(C−1)/C bytes
    against t1_op_us, the single-device fused op per ciphertext. Both
    bounds are reported:
      serialized : every collective on the critical path
      pipelined  : digit-phase comm hidden under digit-phase compute up to
                   max(comp, comm) (digit_mac_fraction = the digit NTTs'
                   share of the op's multiply-accumulates)
    """
    n = 1 << log_n
    C, LS, L = coeff_shards, limb_shards, nlimb
    L_loc = max(1, L // LS)
    n_loc = n // C
    b_intt = batch * L_loc * n_loc * 4 * (C - 1) / C
    b_ag = batch * (L - L_loc) * n_loc * 4
    b_dig = L * batch * L_loc * n_loc * 4 * (C - 1) / C
    kB = bw_GBps * 1e3  # bytes per us
    t_comp = batch * t1_op_us / (C * LS)
    n_coll = (1 if C > 1 else 0) + (1 if LS > 1 else 0) + (L if C > 1 else 0)
    t_comm_serial = (b_intt + b_ag + b_dig) / kB + n_coll * lat_us
    # pipelined: the digit phase runs at max(compute, comm); pre-phase
    # (tensor product + iNTT + all_gather) stays serial
    t_pre = (1 - digit_mac_fraction) * t_comp + (b_intt + b_ag) / kB \
        + (2 if LS > 1 else 1) * lat_us
    t_dig = max(digit_mac_fraction * t_comp, b_dig / kB + lat_us)
    eff_serial = t_comp / (t_comp + t_comm_serial)
    eff_pipe = t_comp / (t_pre + t_dig) if C > 1 or LS > 1 else 1.0
    return {
        "coeff_shards": C, "limb_shards": LS, "batch": batch,
        "bytes_intt_a2a": int(b_intt), "bytes_limb_allgather": int(b_ag),
        "bytes_digit_a2as": int(b_dig),
        "t_comp_us": round(t_comp, 2),
        "efficiency_serialized": round(eff_serial, 3),
        "efficiency_digit_pipelined": round(min(1.0, eff_pipe), 3),
    }


def weak_sweep(log_n_per_shard: int = 12, nlimb: int = 4, batch: int = 2,
               iters: int = 10, device_type: str = "cuda"):
    """Weak scaling (bench_scaling.py:161): 2^log_n_per_shard coefficients
    per rank, so the ring grows with the shard count and the ideal time is
    flat. Ranks that share a host's cores cap the concurrency; the points
    record that oversubscription and report the raw efficiency only."""
    n_dev = dist.get_world_size()
    cores = multiprocessing.cpu_count()
    pts = []
    for c in (1, 2, 4, 8):
        if c > n_dev:
            continue
        dt, shape = measure_dist_ntt(log_n_per_shard + c.bit_length() - 1,
                                     nlimb, c, batch, iters, "a2a", device_type)
        pts.append({
            "coeff_shards": c, "log_n": log_n_per_shard + c.bit_length() - 1,
            "mesh": list(shape), "us_per_call": round(dt * 1e6, 1),
            "host_core_oversubscription": round(max(1.0, c / cores), 2),
        })
    base = pts[0]["us_per_call"]
    for pt in pts:
        pt["weak_efficiency"] = round(base / pt["us_per_call"], 3)
        pt["host_core_limited"] = pt["host_core_oversubscription"] > 1.0
    return pts


def card_note(device_type: str) -> str:
    """The card's name and power limit (nvidia-smi), or the CPU's cores."""
    if device_type != "cuda":
        return f"cpu, {multiprocessing.cpu_count()} cores"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name()


def measure_anchors(reps: int = 20) -> dict:
    """The predictions' single-device anchors on this rank's card: µs of
    the standalone forward NTT of [8, 8, n] per [8, n] transform (queue
    depth 8) at n = 2^15 and 2^16, and fast.mul_relin's µs per ciphertext
    at n = 2^15, L = 8, zp = 2 with Shoup hints over 16 ciphertexts
    (CUDA events)."""
    from alchemy_tpu_torch.she import fast

    def event_us(fn):
        fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / reps

    rng = np.random.default_rng(0)
    t1 = {}
    for log_n in (15, 16):
        p = FastParams.make(log_n, 8)
        x = fast._uniform(rng, p.qs, p.n, "cuda").expand(8, -1, -1).contiguous()
        t1[log_n] = event_us(lambda: fast._ntt_p(p, x)) / 8
    p = FastParams.make(15, 8, zp=2)
    s = fast.keygen(p, rng, device="cuda")
    hb, ha = fast.relin_hint(p, s, rng, shoup=True)
    cts = torch.stack([fast.encrypt(p, s, rng.integers(0, 2, p.n), rng) for _ in range(16)])
    t1_op = event_us(lambda: fast.mul_relin(p, cts, cts, hb, ha)) / 16
    return {"t1_us": t1, "t1_op_us": t1_op}


def sweep(log_n: int = 12, nlimb: int = 4, batch: int = 2, iters: int = 20,
          device_type: str = "cuda", anchors: dict | None = None,
          bandwidths=BANDWIDTHS) -> dict:
    """Fixed-problem-size sweep over coeff shard counts and strategies, the
    weak-scaling points, the communication split and the two predictions
    (bench_scaling.py:197), with the JAX package's keys. `anchors`
    ({"t1_us": {15: us, 16: us}, "t1_op_us": us}) default to rank 0's
    `measure_anchors` on the card; on the CPU the caller passes them."""
    n_dev = dist.get_world_size()
    source = "the caller" if anchors is not None else f"rank 0's {card_note(device_type)}"
    if anchors is None:
        if device_type != "cuda":
            raise ValueError("sweep on the CPU needs its anchors passed in")
        box = [measure_anchors() if dist.get_rank() == 0 else None]
        dist.broadcast_object_list(box, src=0)
        anchors = box[0]
    out = {
        "log_n": log_n, "nlimb": nlimb, "batch": batch,
        "devices": n_dev,
        "platform": device_type,
        "host_cores": multiprocessing.cpu_count(),
        "note": (f"{n_dev} ranks ({dist.get_backend()}) on {card_note(device_type)}; "
                 "ranks that share a host or a card validate the harness and the "
                 "communication pattern, not the interconnect"),
        "points": [],
    }
    shards = [c for c in (1, 2, 4, 8) if c <= n_dev]
    for c in shards:
        for strat in (["a2a"] if c == 1 else ["a2a", "ring"]):
            dt, shape = measure_dist_ntt(log_n, nlimb, c, batch, iters, strat, device_type)
            out["points"].append({
                "coeff_shards": c, "strategy": strat, "mesh": list(shape),
                "us_per_call": round(dt * 1e6, 1),
            })
    base = out["points"][0]["us_per_call"]
    for pt in out["points"]:
        pt["speedup_vs_1shard"] = round(base / pt["us_per_call"], 3)
        pt["parallel_efficiency"] = round(
            base / (pt["us_per_call"] * pt["coeff_shards"]), 3)

    # (a) weak scaling: fixed per-rank work
    out["weak_scaling"] = weak_sweep(log_n, nlimb, batch, max(5, iters // 2), device_type)

    # (b) the collective's cost on this transport: full against the local
    # permutation, plus the chunked overlapped transpose
    # (ALCHEMY_DIST_OVERLAP=2); a user's setting of the variable is put back
    comm = []
    for c in (2, 4, 8):
        if c > n_dev:
            continue
        full, local = measure_comm_split(log_n, nlimb, c, batch, max(5, iters // 2),
                                         device_type)
        old = os.environ.get("ALCHEMY_DIST_OVERLAP")
        os.environ["ALCHEMY_DIST_OVERLAP"] = "2"
        try:
            ov, _ = measure_dist_ntt(log_n, nlimb, c, batch, max(5, iters // 2), "a2a",
                                     device_type)
        finally:
            if old is None:
                del os.environ["ALCHEMY_DIST_OVERLAP"]
            else:
                os.environ["ALCHEMY_DIST_OVERLAP"] = old
        comm.append({
            "coeff_shards": c,
            "full_us": round(full * 1e6, 1),
            "local_only_us": round(local * 1e6, 1),
            "collective_us": round((full - local) * 1e6, 1),
            "overlapped_chunks2_us": round(ov * 1e6, 1),
        })
    out["comm_split"] = comm

    # (c) the NTT's strong scaling at n = 2^15 and 2^16, L = 8, anchored on
    # the measured single-device transform
    preds = []
    for ln in (15, 16):
        t1 = anchors["t1_us"][ln]
        for bw in bandwidths:
            for c in (2, 4, 8):
                for b in (1, 4):
                    e = predict_ici_efficiency(ln, 8, c, b, t1 * b, bw)
                    e.update({"log_n": ln, "batch": b, "ici_GBps": bw})
                    preds.append(e)
    out["ici_prediction"] = {
        "model": "T_comp = t1/C; T_comm = batch*L*(n/C)*4*(C-1)/C / BW + 1us; "
                 "eff = T_comp/(T_comp+T_comm); t1 = the single-device [8, n] transform "
                 "(queue depth 8)",
        "t1_us": {str(k): v for k, v in anchors["t1_us"].items()},
        "anchors_from": source,
        "comm_term_anchor": "bytes/BW + lat with BW an argument (GB/s per rank)",
        "points": preds,
    }

    # (d) the full distributed mul+relin, anchored on fast.mul_relin
    full_pts = []
    for bw in bandwidths:
        for c, ls in ((2, 1), (4, 1), (8, 1), (4, 2), (2, 2)):
            for b in (1, 4, 16):
                e = predict_full_op_efficiency(15, 8, c, ls, b, anchors["t1_op_us"], bw)
                e.update({"log_n": 15, "ici_GBps": bw})
                full_pts.append(e)
    out["full_op_prediction"] = {
        "model": "see predict_full_op_efficiency docstring; "
                 "t1_op = the single-device fused mult+relin per ct",
        "t1_op_us": anchors["t1_op_us"],
        "anchors_from": source,
        "points": full_pts,
    }
    return out


def main(argv=None) -> int:
    import argparse

    from alchemy_tpu_torch.parallel.multihost import init_multihost

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--t1-us", type=float, nargs=2, metavar=("N2E15", "N2E16"),
                    help="the transform anchors, µs (needed with --device cpu)")
    ap.add_argument("--t1-op-us", type=float, help="the mul+relin anchor, µs per ciphertext")
    args = ap.parse_args(argv)
    anchors = None
    if args.t1_us and args.t1_op_us:
        anchors = {"t1_us": dict(zip((15, 16), args.t1_us)), "t1_op_us": args.t1_op_us}
    init_multihost(backend="nccl" if args.device == "cuda" else "gloo")
    print(json.dumps(sweep(device_type=args.device, anchors=anchors), indent=1))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
