"""Rank-side halves of the port's distributed tests (test_torch_parallel.py,
test_torch_pipeline.py, test_torch_multihost.py).

Each function runs on every rank of a `LocalWorld` of gloo processes on the
CPU: it builds the port's mesh, carries numpy uint32 inputs (made in the
pytest process from a seed) into DTensors with `distribute_tensor`
(every rank holds the same full value, so nothing is scattered), runs one
port op and returns numpy uint32 results from rank 0 (None elsewhere). The
pytest process holds them against the JAX package. This module imports
torch and the port, never jax.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from alchemy_tpu_torch.backend.modarith import narrow, qcol, widen
from alchemy_tpu_torch.convert import to_numpy, to_torch
from alchemy_tpu_torch.parallel import dist as D
from alchemy_tpu_torch.parallel.mesh import make_mesh
from alchemy_tpu_torch.she.fast import FastParams


def _cfg(n: int, qs, impl: str, n1: int) -> D.DistConfig:
    return D.DistConfig(p=FastParams(n=n, qs=tuple(qs), zp=2, impl=impl), n1=n1, n2=n // n1)


def _dt(x, mesh, placements):
    return distribute_tensor(to_torch(x, mesh.device_type), mesh, placements, src_data_rank=None)


def _full(*xs):
    """Full values of DTensors as uint32 numpy on rank 0 (a collective)."""
    out = tuple(to_numpy(x.full_tensor()) for x in xs)
    return (out if len(out) > 1 else out[0]) if dist.get_rank() == 0 else None


def dist_ntt(shape, n, qs, impl, n1, x, strategy=None, overlap=None):
    """make_dist_ntt's forward and inverse of x [B, L, n] (storage order):
    (fwd(x), inv(fwd(x))) and the collective calls of one forward, by op
    and axis. overlap sets ALCHEMY_DIST_OVERLAP for the call."""
    old = os.environ.get("ALCHEMY_DIST_OVERLAP")
    if overlap is not None:
        os.environ["ALCHEMY_DIST_OVERLAP"] = str(overlap)
    try:
        mesh = make_mesh(shape, "cpu")
        fwd, inv = D.make_dist_ntt(_cfg(n, qs, impl, n1), mesh, strategy=strategy)
        xd = _dt(x, mesh, D.NTT_PLACEMENTS)
        D.reset_collectives()
        y = fwd(xd)
        calls = dict(D.COLLECTIVES)
        D.reset_collectives()
        r = inv(y)
        inv_calls = dict(D.COLLECTIVES)
        full = _full(y, r)
    finally:
        if old is None:
            os.environ.pop("ALCHEMY_DIST_OVERLAP", None)
        else:
            os.environ["ALCHEMY_DIST_OVERLAP"] = old
    return None if full is None else (*full, calls, inv_calls)


def dist_pointwise(shape, n, qs, impl, n1, a, b):
    """inv(fwd(a) ⊙ fwd(b)) mod q on the mesh: the sharded ring product."""
    mesh = make_mesh(shape, "cpu")
    fwd, inv = D.make_dist_ntt(_cfg(n, qs, impl, n1), mesh)
    fa, fb = (widen(fwd(_dt(v, mesh, D.NTT_PLACEMENTS)).to_local()) for v in (a, b))
    L_loc, li = fa.shape[1], mesh.get_local_rank("limb")
    prod = fa * fb % qcol(qs[li * L_loc:(li + 1) * L_loc], "cpu")
    return _full(inv(DTensor.from_local(narrow(prod), mesh, D.NTT_PLACEMENTS, run_check=False)))


def dist_mul_relin(shape, n, qs, impl, n1, ct_a, ct_b, hb, ha, strategy=None,
                   hint_placement="digit", device_type="cpu"):
    mesh = make_mesh(shape, device_type)
    run = D.make_dist_mul_relin(_cfg(n, qs, impl, n1), mesh, strategy=strategy,
                                hint_placement=hint_placement)
    hspec = D.ROW_HINT_PLACEMENTS if hint_placement == "row" else D.HINT_PLACEMENTS
    out = run(_dt(ct_a, mesh, D.CT_PLACEMENTS), _dt(ct_b, mesh, D.CT_PLACEMENTS),
              _dt(hb, mesh, hspec), _dt(ha, mesh, hspec))
    return _full(out)


def dist_chain(shape, n, qs, impl, n1, ct, hints):
    """The padded deep chain on the mesh: for each level's (hb, ha) (dist
    NTT domain, [L0, L0, n]) make_dist_mul_relin then make_dist_rescale at
    the level's active limb count; returns every level's ciphertext."""
    mesh = make_mesh(shape, "cpu")
    cfg = _cfg(n, qs, impl, n1)
    run_mul = D.make_dist_mul_relin(cfg, mesh)
    ct_d = _dt(ct, mesh, D.CT_PLACEMENTS)
    levels = []
    for level, (hb, ha) in enumerate(hints):
        out = run_mul(ct_d, ct_d, _dt(hb, mesh, D.HINT_PLACEMENTS),
                      _dt(ha, mesh, D.HINT_PLACEMENTS))
        ct_d = D.make_dist_rescale(cfg, mesh, len(qs) - level)(out)
        levels.append(_full(ct_d))
    return levels


def dist_hybrid(shape, n, qs, impl, n1, k_sp, ct_a, ct_b, hb, ha):
    """make_dist_mul_relin_hybrid with the port's HybridKS over the chain qs
    (dnum by `pick_dnum`, k_sp special primes)."""
    from alchemy_tpu_torch.she.hybrid import HybridKS

    mesh = make_mesh(shape, "cpu")
    cfg = _cfg(n, qs, impl, n1)
    hk = HybridKS.make(cfg.p, k_sp=k_sp)
    run = D.make_dist_mul_relin_hybrid(hk, cfg, mesh)
    out = run(_dt(ct_a, mesh, D.CT_PLACEMENTS), _dt(ct_b, mesh, D.CT_PLACEMENTS),
              _dt(hb, mesh, D.HINT_PLACEMENTS), _dt(ha, mesh, D.HINT_PLACEMENTS))
    return _full(out)


def strategy_of(shape):
    return D.pick_dist_strategy(make_mesh(shape, "cpu"))


def dryrun(n_devices):
    from alchemy_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(n_devices, device_type="cpu")
    return _full(out["mul_relin"], out["rescale"], out["hybrid"])


def pipeline(shape, names, n, qs, impl, hints, mb, n_micro, batch, device_type="cpu"):
    """make_pipeline_chain on the mesh `shape` with axis names `names` (one
    of them 'stage'): the chain's result (shard S − 1 of the output), this
    rank's device bytes of hints and of input, and the collective calls."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard

    from alchemy_tpu_torch.parallel.pipeline import make_pipeline_chain

    mesh = init_device_mesh(device_type, shape, mesh_dim_names=names)
    p = FastParams(n=n, qs=tuple(qs), zp=2, impl=impl)
    run = make_pipeline_chain(p, mesh, hints, mb=mb, n_micro=n_micro)
    placements = [Shard(0) if a == "stage" else Replicate() for a in names]
    cts = _dt(batch, mesh, placements)
    D.reset_collectives()
    out = run(cts)
    calls = dict(D.COLLECTIVES)
    hb, ha, _ = run._hint_args
    local = {"hint_bytes": hb.numel() * hb.element_size() + ha.numel() * ha.element_size(),
             "input_bytes": cts.to_local().numel() * cts.to_local().element_size(),
             "calls": calls}
    S = mesh["stage"].size() if len(names) > 1 else mesh.size()
    full = to_numpy(out.full_tensor())[S - 1]
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, local)
    return (full, gathered) if dist.get_rank() == 0 else None


def pipeline_on_card(n, qs, impl, hints, mb, n_micro, batch):
    """`pipeline` on one rank on the card (S = 1): the chain's result."""
    out = pipeline((1,), ("stage",), n, qs, impl, hints, mb, n_micro, batch, "cuda")
    return out[0]


def dist_ntt_on_card(shape, n, qs, impl, n1, x):
    """The dist NTT round trip on CUDA tensors (mesh on the card): the
    result, read back through a CPU mesh, and the bytes the comm helpers
    staged through host memory."""
    torch.cuda.set_device(0)
    mesh, cpu_mesh = make_mesh(shape, "cuda"), make_mesh(shape, "cpu")
    fwd, inv = D.make_dist_ntt(_cfg(n, qs, impl, n1), mesh)
    D.reset_collectives()
    r = inv(fwd(_dt(x, mesh, D.NTT_PLACEMENTS)))
    staged = sum(D.STAGED_BYTES.values())
    full = DTensor.from_local(r.to_local().cpu(), cpu_mesh, D.NTT_PLACEMENTS,
                              run_check=False).full_tensor()
    return (to_numpy(full), staged) if dist.get_rank() == 0 else None
