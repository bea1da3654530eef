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


# ---------------------------------------------------------------------------
# whole compiled programs on a ('limb', 'coeff') mesh (test_torch_jit_mesh*.py)
# ---------------------------------------------------------------------------


def example_program(name: str, bk):
    """The compiled program of a shipped example at the seed of its test in
    tests/test_jit_exec.py, on bk: (compiled, argument CTs, the plaintext
    result). "addOnly" is Arithmetic's setting with `x + y`."""
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.interp.eval import eval_ir
    from alchemy_tpu_torch.interp.keys_hints import KeysHints
    from alchemy_tpu_torch.interp.pt2ct import pt2ct
    from alchemy_tpu_torch.nt.factor import totient
    from alchemy_tpu_torch.she.gadget import BaseBGad, TrivGad

    if name in ("Arithmetic", "addOnly"):
        from alchemy_tpu_torch.examples import arithmetic as ex
        from alchemy_tpu_torch.lang.dsl import lam2

        expr = ex.addMul if name == "Arithmetic" else lam2(lambda x, y: x + y)
        rng = np.random.default_rng(4)
        pts = [Cyc.from_coeffs(ex.M, (ex.ZP,), rng.integers(0, ex.ZP, totient(ex.M)), bk)
               for _ in range(2)]
        ctx = KeysHints(3.0, seed=4, bk=bk)
        compiled = pt2ct(expr, res_ty=ex.PT, m_map=ex.M_MAP, zqs=ex.ZQS, gad=TrivGad(), ctx=ctx)
        args = [compiled.encrypt_arg(pt, i) for i, pt in enumerate(pts)]
        return compiled, args, eval_ir(expr, *pts)
    from alchemy_tpu_torch.examples.common import H0, M_MAP, switch

    if name == "Tunnel":
        from alchemy_tpu_torch.examples.tunnel import PT, ZP, ZQS

        rng = np.random.default_rng(1)
        expr = switch(3, ZP, bk)
        x = Cyc.from_coeffs(H0, (ZP,), rng.integers(0, ZP, totient(H0)), bk)
        ctx = KeysHints(3.0, seed=1, bk=bk)
        compiled = pt2ct(expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=BaseBGad(2), ctx=ctx)
        return compiled, [compiled.encrypt_arg(x, 0)], eval_ir(expr, x)
    from alchemy_tpu_torch.examples.homomrlwr import PT, ZP_IN, ZQS, ring_round
    from alchemy_tpu_torch.she import bgv

    rng = np.random.default_rng(7)
    expr = ring_round(bk)
    ctx = KeysHints(5.0, seed=7, bk=bk)
    compiled = pt2ct(expr, res_ty=PT, m_map=M_MAP, zqs=ZQS, gad=TrivGad(), ctx=ctx)
    s = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)
    a = Cyc.from_coeffs(H0, (ZP_IN,), rng.integers(0, ZP_IN, totient(H0)), bk)
    return compiled, [bgv.mul_public(a, compiled.encrypt_arg(s, 0))], eval_ir(expr, s * a)


def block_of(t: torch.Tensor, shape, limb_rank: int, coeff_rank: int) -> torch.Tensor:
    """The block of a whole [L, n] array that the rank at (limb_rank,
    coeff_rank) of a mesh of `shape` holds: rows [i·b, (i + 1)·b) with
    b = ⌈L / limb⌉, zero-padded past L, and the coeff_rank-th of `coeff`
    column blocks (all columns when they do not split)."""
    LS, C = shape
    L, n = t.shape
    b = -(-L // LS)
    rows = t[limb_rank * b:(limb_rank + 1) * b]
    rows = torch.cat((rows, rows.new_zeros((b - rows.shape[0], n))))
    return rows[:, coeff_rank * (n // C):(coeff_rank + 1) * (n // C)] if n % C == 0 else rows


def jit_mesh(name: str, shape, probe: bool = False, device_type: str = "cpu"):
    """One example's compiled program through the port's jit_compile,
    single-device and on the ('limb', 'coeff') mesh of `shape`: whether this
    rank's blocks of the result equal the blocks of the single-device
    result, whether the gathered result decrypts to the plaintext (and, with
    `probe`, whether the strict error-rate logs are equal), this rank's
    collectives and bytes, the single-device bytes; rank 0 adds the gathered
    result as numpy."""
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.interp.jit_exec import jit_compile

    torch.set_num_threads(1)
    bk = TorchBackend(device_type)
    compiled, args, want = example_program(name, bk)
    kw = {"noise_probe": compiled.ctx, "strict": True} if probe else {}
    single_fn = jit_compile(compiled, args, **kw)
    mesh = init_device_mesh(device_type, tuple(shape), mesh_dim_names=("limb", "coeff"))
    fn = jit_compile(compiled, args, mesh=mesh, **kw)
    single, out = single_fn(*args), fn(*args)
    logs_equal = True
    if probe:
        (single, slog), (out, log) = single, out
        logs_equal = slog == log
    li, ci = mesh.get_local_rank("limb"), mesh.get_local_rank("coeff")
    blocks_equal = all(
        torch.equal(c.data.local.cpu(), block_of(s.data.cpu(), shape, li, ci))
        for s, c in zip(single.comps, out.comps))
    whole = fn.gather(out)
    res = {"blocks_equal": blocks_equal, "logs_equal": logs_equal,
           "whole_equal": all(torch.equal(s.data.cpu(), w.data.cpu())
                              for s, w in zip(single.comps, whole.comps)),
           "decrypts": compiled.decrypt(whole).equals(want),
           "meta": (out.m, out.zp, out.scale, out.qs, [c.basis for c in out.comps]),
           "collectives": dict(fn.collectives), "comm_ops": dict(fn.sbk.comm_ops),
           "bytes": fn.arg_bytes(), "single_bytes": single_fn.arg_bytes()}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, res)
    if dist.get_rank() != 0:
        return None
    return gathered, [c.data.cpu().numpy() for c in whole.comps]


def spmd_ops(shape, seed: int):
    """Each `ShardedTorchBackend` method, through the `Cyc` and SHE code
    that calls it, on the ('limb', 'coeff') mesh of `shape`, against the
    same code on `TorchBackend("cpu")`: per case, whether the whole result
    (every rank's `full`) equals the single-device one on every rank, and
    the collectives the case made, by (op, axis). Chains of 5 and 6 limbs
    over R_180 (φ = 48) and R_36, a rescale from 6 to 5 and from 5 to 4, a
    modswitch from 3 to 5 limbs, and R_9 (φ = 6, whose coefficients do not
    split over 4)."""
    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.core.cyc import Cyc
    from alchemy_tpu_torch.core.ring import get_ring
    from alchemy_tpu_torch.nt.primes import find_ntt_prime
    from alchemy_tpu_torch.parallel.spmd import ShardedTorchBackend
    from alchemy_tpu_torch.she import bgv
    from alchemy_tpu_torch.she.gadget import BaseBGad, HybridGad, TrivGad

    torch.set_num_threads(1)
    tb = TorchBackend("cpu")
    mesh = init_device_mesh("cpu", tuple(shape), mesh_dim_names=("limb", "coeff"))
    sb = ShardedTorchBackend(mesh)
    qs = []
    for _ in range(6):
        qs.append(find_ntt_prime(180, 30, avoid=tuple(qs)))
    q6, q5, q3 = tuple(qs), tuple(qs[:5]), tuple(qs[:3])
    rng = np.random.default_rng(seed)

    def arr(m, chain):
        return np.stack([rng.integers(0, q, get_ring(m).phi) for q in chain])

    data = {"a": (180, q5, arr(180, q5)), "b": (180, q5, arr(180, q5)),
            "c6": (180, q6, arr(180, q6)), "c3": (180, q3, arr(180, q3)),
            "s": (36, q5, arr(36, q5)), "odd": (9, q5[:2], arr(9, q5[:2])),
            "row": (180, q5, rng.integers(-1000, 1000, 48))}

    def cycs(bk):
        return {k: Cyc(get_ring(m), ch, "POW", bk.asarray(v, ch), bk)
                for k, (m, ch, v) in data.items() if k != "row"}

    cases = {
        "add": lambda x, bk: x["a"] + x["b"],
        "sub": lambda x, bk: x["a"] - x["b"],
        "neg": lambda x, bk: -x["a"],
        "scalar_mul": lambda x, bk: x["a"].scalar_mul(-123456789),
        "sum_terms": lambda x, bk: x["a"].like(bk.sum_terms([x["a"].data, x["b"].data,
                                                            x["a"].data], q5)),
        "zeros": lambda x, bk: Cyc.zero(180, q5, bk),
        "broadcast_row": lambda x, bk: x["a"].like(bk.broadcast_row(data["row"][2], 5, q5)),
        "reduce_signed": lambda x, bk: x["a"].like(bk.reduce_signed(
            np.stack([data["row"][2]] * 5), q5)),
        "to_crt": lambda x, bk: x["a"].to_crt(),
        "crt_mul": lambda x, bk: x["a"] * x["b"],
        "to_crt_odd_ring": lambda x, bk: x["odd"].to_crt(),
        "embed": lambda x, bk: x["s"].embed(180),
        "twace": lambda x, bk: x["a"].twace(36),
        "rel_coeffs_dec": lambda x, bk: x["a"].rel_coeffs(36, basis="dec"),
        "from_rel_coeffs": lambda x, bk: Cyc.from_rel_coeffs(
            180, 36, x["a"].rel_coeffs(36), q5, bk),
        "batched_to_basis": lambda x, bk: Cyc.batched_to_basis([x["a"], x["b"]], "CRT"),
        "batched_embed_crt": lambda x, bk: Cyc.batched_embed_crt([x["s"], x["s"] + x["s"]], 180),
        "trivgad_digits": lambda x, bk: TrivGad().digits(x["a"]),
        "basebgad_digits": lambda x, bk: BaseBGad(2).digits(x["c3"]),
        "hybridgad_digits": lambda x, bk: HybridGad(dnum=2).digits(x["a"]),
        "rescale_6_to_5": lambda x, bk: bgv._rescale_drop_last(x["c6"], 2),
        "rescale_5_to_4": lambda x, bk: bgv._rescale_drop_last(x["a"], 2),
        "modswitch_3_to_5": lambda x, bk: x["c3"].like(bk.modswitch_up(x["c3"].data, q3, q5),
                                                       qs=q5),
        "lift_centered": lambda x, bk: bk.lift_centered(x["a"].data, q5),
    }

    def whole(r, bk):
        if isinstance(r, list):
            return [whole(v, bk) for v in r]
        if isinstance(r, np.ndarray):
            return r
        return (r.m, r.qs, r.basis, bk.to_numpy(r.data))

    ref, mine = cycs(tb), cycs(sb)
    out = {}
    for name, fn in cases.items():
        want = whole(fn(ref, tb), tb)
        sb.reset_collectives()
        got = fn(mine, sb)
        calls = dict(sb.collectives)
        got = whole(got, sb)
        same = repr(got) == repr(want) and all(
            np.array_equal(g, w) for g, w in zip(_arrays(got), _arrays(want)))
        flags = [None] * dist.get_world_size()
        dist.all_gather_object(flags, same)
        out[name] = (all(flags), calls)
    return out if dist.get_rank() == 0 else None


def _arrays(x):
    if isinstance(x, np.ndarray):
        return [x]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _arrays(v)]
    return []


def sharding_fallback(shape, mesh_shape):
    """The port's `_auto_sharding` of a zero [shape] array on the
    ('limb', 'coeff') mesh of `mesh_shape`: (placement names per mesh axis,
    the warnings' categories)."""
    import warnings

    from torch.distributed.device_mesh import init_device_mesh

    from alchemy_tpu_torch.interp.jit_exec import _auto_sharding

    mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=("limb", "coeff"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pl = _auto_sharding(torch.zeros(shape, dtype=torch.int64), mesh)
    return [repr(p) for p in pl], [w.category.__name__ for w in caught]


def scaling_sweep(log_n: int, iters: int, anchors: dict, overlap):
    """The port's bench_scaling.sweep on the CPU ranks with
    ALCHEMY_DIST_OVERLAP set to `overlap` (None: unset) by the caller: the
    sweep, the variable after it, and the DIST_STRATEGIES keys before and
    after it."""
    from alchemy_tpu_torch.parallel import bench_scaling

    old = os.environ.pop("ALCHEMY_DIST_OVERLAP", None)
    if overlap is not None:
        os.environ["ALCHEMY_DIST_OVERLAP"] = overlap
    try:
        before = sorted(D.DIST_STRATEGIES)
        out = bench_scaling.sweep(log_n=log_n, iters=iters, device_type="cpu", anchors=anchors)
        return (out, os.environ.get("ALCHEMY_DIST_OVERLAP", "unset"),
                before, sorted(D.DIST_STRATEGIES))
    finally:
        os.environ.pop("ALCHEMY_DIST_OVERLAP", None)
        if old is not None:
            os.environ["ALCHEMY_DIST_OVERLAP"] = old
