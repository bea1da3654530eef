"""Distributed BGV hot path on torch.distributed over the ('batch', 'limb',
'coeff') mesh — port of `alchemy_tpu/parallel/dist.py`.

The distributed NTT is the 4-step factorization n = n1·n2: coefficients are
stored in (j2, j1) grid order (pos = j2·n1 + j1) and the 'coeff' mesh axis
shards j2-blocks, so

  1. local cyclic NTT of size n1 along j1 (rows are complete locally),
  2. local twiddle by w^(j2·k1),
  3. ONE all_to_all transpose over the 'coeff' group (k1 becomes the
     sharded axis),
  4. local cyclic NTT of size n2 along j2,

with the negacyclic ψ-twist as sharded elementwise pre/post tables. The
final slot order is (k1-bitrev, k2-bitrev) blocks — fixed and self-inverse,
which is all pointwise ct ops need.

Relinearization traffic: one all_gather of the c2 coefficient rows over
'limb' (digits are elementwise per coefficient, so 'coeff' stays sharded);
hint products are limb-local. 'batch' never communicates.

Torch has no `shard_map`. Each `make_dist_*` is called on every rank of the
mesh and returns a `run` whose arguments and result are DTensors
(`torch.distributed.tensor`) with the `Shard` placements that spell the JAX
PartitionSpecs (`CT_PLACEMENTS` is P("batch", None, "limb", "coeff"), ...);
`run` takes each rank's local shard, runs the step on it, and every
collective names its mesh group: `all_to_all_single` on 'coeff',
`all_gather_into_tensor` and `all_reduce` on 'limb', `batch_isend_irecv` for
the ring's ppermute rounds. Each rank holds its own slices of the tables
(the JAX package's sharded table arguments). The local stages are torch ops
in int64, as they are jnp ops in the JAX package (no Pallas kernel runs
here): every Shoup product is the exact int64 product mod q and sums wrap
at 32 bits, so each rank's residues equal the JAX package's. Residues move
between ranks as int32 (the uint32 bit pattern), sums (`all_reduce`) as
int64. Over a gloo group a CUDA tensor is staged through host memory by the
comm helpers here, and each staged byte is counted (`STAGED_BYTES`): gloo
moves CUDA tensors itself in all_to_all, all_gather and all_reduce, but
not in point-to-point sends (torch 2.11 on an H100), so every op takes the
same, counted, route. Every collective call is counted by (op, mesh axis)
in `COLLECTIVES`.
"""

from __future__ import annotations

import os
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from alchemy_tpu_torch.backend.modarith import (
    _add_mod,
    _cond_sub,
    _extend_consts,
    garner_digits,
    narrow,
    shoup_const,
    widen,
)
from alchemy_tpu_torch.backend.ntt import cyclic_intt_stages, cyclic_ntt_stages
from alchemy_tpu_torch.backend.ntt3 import psi_powers
from alchemy_tpu_torch.parallel.mesh import check_device_type
from alchemy_tpu_torch.she.fast import FastParams
from alchemy_tpu_torch.she.hybrid import _sign_terms

#: P("batch", None, "limb", "coeff"): ciphertexts [B, 2, L, n]
CT_PLACEMENTS = (Shard(0), Shard(2), Shard(3))
#: P(None, "limb", "coeff"): hints [L, L, n] / [dnum, T, n] (digit placement)
HINT_PLACEMENTS = (Replicate(), Shard(1), Shard(2))
#: P("limb", None, "coeff"): hints sharded by gadget row (row placement)
ROW_HINT_PLACEMENTS = (Replicate(), Shard(0), Shard(2))
#: P("batch", "limb", "coeff"): rows [B, L, n] of `make_dist_ntt`
NTT_PLACEMENTS = (Shard(0), Shard(1), Shard(2))

#: collective calls since the last reset, by (op, mesh axis)
COLLECTIVES: Counter = Counter()
#: bytes staged through host memory for gloo collectives of CUDA tensors
STAGED_BYTES: Counter = Counter()


def reset_collectives() -> None:
    COLLECTIVES.clear()
    STAGED_BYTES.clear()


def _bitrev(i: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (i & 1)
        i >>= 1
    return r


@dataclass(frozen=True)
class DistConfig:
    p: FastParams
    n1: int
    n2: int

    def __post_init__(self):
        assert self.n1 * self.n2 == self.p.n


@lru_cache(maxsize=None)
def dist_tables(cfg: DistConfig):
    """Host numpy tables for the 4-step distributed negacyclic NTT
    (dist.py:62), uint32 as there.

    Layout-sensitive tables are in storage order and sharded like the data;
    stage tables are per-limb [L, m] (sharded over 'limb'). Every entry is a
    power of ψ = root_of_unity(2n, q) (times n⁻¹ in `post`), read from one
    table of ψ^e (e < 2n) by its exponent: the same integers as the JAX
    package's per-entry modular powers."""
    p, n1, n2 = cfg.p, cfg.n1, cfg.n2
    qs, n = p.qs, p.n
    L = len(qs)
    b1 = n1.bit_length() - 1
    two_n = 2 * n

    def u32(vals):
        return np.asarray(vals, dtype=np.int64).astype(np.uint32)

    def shoup(vals, q):
        return u32((np.asarray(vals, dtype=np.int64) << 32) // q)

    pos = np.arange(n, dtype=np.int64)
    j = (pos % n1) * n2 + pos // n1                  # storage pos = j2·n1 + j1
    brv = np.array([_bitrev(k, b1) for k in range(n1)], dtype=np.int64)
    e_tw = (2 * np.arange(n2, dtype=np.int64)[:, None] * brv[None, :]) % two_n  # w^(j2·k1)

    def stage_exps(order_exp):
        """Per stage, the exponents of ψ of the twiddles of a cyclic NTT of
        size n / order_exp with root w^order_exp (dist.py:112-142)."""
        size = n // order_exp
        return [(2 * order_exp * ((np.arange(size >> (s + 1), dtype=np.int64) << s) % size))
                % two_n for s in range(size.bit_length() - 1)]

    pre, post, tw, itw = ([] for _ in range(4))
    s1 = [([], []) for _ in stage_exps(n2)]
    s2 = [([], []) for _ in stage_exps(n1)]
    for q in qs:
        pw = psi_powers(n, q)
        n_inv = pow(n, -1, q)
        pre.append(pw[j])
        post.append(pw[(two_n - j) % two_n] * n_inv % q)
        tw.append(pw[e_tw])
        itw.append(pw[(two_n - e_tw) % two_n])
        for out, exps in ((s1, stage_exps(n2)), (s2, stage_exps(n1))):
            for (fwd, inv), e in zip(out, exps):
                fwd.append(pw[e])
                inv.append(pw[(two_n - e) % two_n])
    qv = np.array(qs, dtype=np.int64)[:, None]

    def pair(rows, shape=None):
        v = np.stack(rows)
        v = v.reshape(shape) if shape else v
        return u32(v), shoup(v, qv)

    def stages(tabs, k):
        return [pair(t[k]) for t in tabs]

    return {
        "pre": pair(pre),
        "post": pair(post),
        "tw": pair(tw, (L, n)),
        "itw": pair(itw, (L, n)),
        "stage1": stages(s1, 0),
        "stage1_inv": stages(s1, 1),
        "stage2": stages(s2, 0),
        "stage2_inv": stages(s2, 1),
        "q": u32(qv),
        "r16": u32([[(1 << 16) % q] for q in qs]),
        "r16s": u32([[shoup_const((1 << 16) % q, q)] for q in qs]),
    }


def _device(mesh) -> torch.device:
    """The device of this rank's shards: the mesh's type, raising for
    "cuda" without a card."""
    check_device_type(mesh.device_type)
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


@lru_cache(maxsize=None)
def _local_tables(cfg: DistConfig, li: int, LS: int, ci: int, C: int, device: str) -> dict:
    """This rank's slices of `dist_tables` as int64 tensors on device: limb
    shard li of LS ([L/LS] rows) and coefficient shard ci of C (the
    `_tab_specs` placements, dist.py:512)."""
    t = dist_tables(cfg)
    L, n = len(cfg.p.qs), cfg.p.n
    rows = slice(li * (L // LS), (li + 1) * (L // LS))
    cols = slice(ci * (n // C), (ci + 1) * (n // C))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64)).to(device)

    out = {k: dev(t[k][0][rows, cols]) for k in ("pre", "post", "tw", "itw")}
    for k in ("stage1", "stage1_inv", "stage2", "stage2_inv"):
        out[k] = [(dev(w[rows]), dev(ws[rows])) for w, ws in t[k]]
    out["q"] = dev(t["q"][rows])
    return out


def _tables_for(cfg: DistConfig, mesh, limb_sharded: bool = True) -> dict:
    """This rank's tables: limb- and coefficient-sharded, or with every limb
    (limb_sharded=False, the row placement's replicated-limb tables)."""
    li, LS = (mesh.get_local_rank("limb"), _size(mesh, "limb")) if limb_sharded else (0, 1)
    return _local_tables(cfg, li, LS, mesh.get_local_rank("coeff"), _size(mesh, "coeff"),
                         str(_device(mesh)))


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


# ---------------------------------------------------------------------------
# collectives on the mesh groups
# ---------------------------------------------------------------------------


def _on_host(x: torch.Tensor, group) -> bool:
    """Whether the group's backend needs x staged through host memory."""
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _staged(x: torch.Tensor, group, op: str, axis: str, fn) -> torch.Tensor:
    """fn(x) with x staged through host memory where the group needs it,
    counted in COLLECTIVES and STAGED_BYTES."""
    COLLECTIVES[op, axis] += 1
    if not _on_host(x, group):
        return fn(x)
    STAGED_BYTES[op, axis] += 2 * x.numel() * x.element_size()
    return fn(x.cpu()).to(x.device)


def _all_to_all(x: torch.Tensor, axis_split: int, axis_concat: int, mesh,
                axis: str = "coeff") -> torch.Tensor:
    """Tiled all_to_all over a mesh axis (jax.lax.all_to_all with
    tiled=True): x split into C chunks along axis_split, chunk i to the
    rank at position i, the C received chunks concatenated along
    axis_concat in order of their sender. Int64 values, moved as int32."""
    group, C = mesh.get_group(axis), _size(mesh, axis)
    nd = x.ndim
    axis_split, axis_concat = axis_split % nd, axis_concat % nd
    xs = narrow(x).unflatten(axis_split, (C, x.shape[axis_split] // C))
    xs = xs.movedim(axis_split, 0).contiguous()

    def a2a(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=group)
        return out

    got = _staged(xs, group, "all_to_all", axis, a2a)   # [C (sender), *chunk]
    return widen(got.movedim(0, axis_concat).flatten(axis_concat, axis_concat + 1))


def _ppermute(x: torch.Tensor, mesh, axis: str, pairs) -> torch.Tensor:
    """jax.lax.ppermute over a mesh axis: for each (src, dst) in pairs the
    rank at position src sends x to the one at dst; a rank that receives
    nothing gets zeros. One `batch_isend_irecv` of x's dtype."""
    group = mesh.get_group(axis)
    me = mesh.get_local_rank(axis)
    send = [dst for src, dst in pairs if src == me]
    recv = [src for src, dst in pairs if dst == me]

    def p2p(t):
        out = torch.zeros_like(t)
        ops = [dist.P2POp(dist.isend, t, dist.get_global_rank(group, d), group)
               for d in send]
        ops += [dist.P2POp(dist.irecv, out, dist.get_global_rank(group, s), group)
                for s in recv]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    return _staged(x.contiguous(), group, "p2p", axis, p2p)


def _all_gather(x: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Tiled all_gather over a mesh axis along dim (int64 values, moved as
    int32)."""
    group, A = mesh.get_group(axis), _size(mesh, axis)
    xs = narrow(x).movedim(dim, 0).contiguous()

    def gather(t):
        out = t.new_empty((A * t.shape[0], *t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    return widen(_staged(xs, group, "all_gather", axis, gather).movedim(0, dim))


def _all_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """psum over a mesh axis (the sum in x's dtype)."""
    group = mesh.get_group(axis)

    def reduce(t):
        t = t.clone()
        dist.all_reduce(t, group=group)
        return t

    return _staged(x.contiguous(), group, "all_reduce", axis, reduce)


# ---------------------------------------------------------------------------
# local (per-shard) transforms, written against local chunk shapes
# ---------------------------------------------------------------------------


def _a2a(x, axis_split, axis_concat, n_shards, mesh):
    return _all_to_all(x, axis_split, axis_concat, mesh)


def _a2a_ring(x, axis_split, axis_concat, n_shards, mesh):
    """Staged-ring transpose (dist.py:188): the ppermute decomposition of
    the tiled all_to_all, bit-identical to it. Round t ∈ 1..C-1 sends
    exactly one [split/C × concat] chunk one hop of distance t: the rank at
    d ships chunk (d+t)%C to (d+t)%C, which lands it at source-block
    position (d-t)%C of the output; C-1 `batch_isend_irecv` rounds instead
    of one global exchange."""
    C = n_shards
    d = mesh.get_local_rank("coeff")
    nd = x.ndim
    axis_split, axis_concat = axis_split % nd, axis_concat % nd
    chunk = x.shape[axis_split] // C
    cat = x.shape[axis_concat]
    out_shape = list(x.shape)
    out_shape[axis_split] = chunk
    out_shape[axis_concat] = cat * C
    out = x.new_zeros(out_shape)
    for t in range(C):
        piece = narrow(x.narrow(axis_split, ((d + t) % C) * chunk, chunk))
        if t:
            piece = _ppermute(piece, mesh, "coeff", [(i, (i + t) % C) for i in range(C)])
        out.narrow(axis_concat, ((d - t) % C) * cat, cat).copy_(widen(piece))
    return out


#: DistNTT strategy registry ("both implemented under one DistNTT
#: interface; pick by slice topology")
DIST_STRATEGIES = {"a2a": _a2a, "ring": _a2a_ring}


def pick_dist_strategy(mesh) -> str:
    """Default transpose strategy: a2a, everywhere (dist.py:226: the ring
    measured no faster than a2a on every transport the JAX package could
    reach). The ring stays available explicitly (strategy="ring",
    bit-identical)."""
    return "a2a"


def _stages_L(x, stages, q, fn):
    """Apply a cyclic stage transform over the last axis of
    [..., L_loc, G, size] (G = grid rows) with per-limb tables [L_loc, m]:
    temporarily move L next to the transform axis for broadcasting."""
    return fn(x.transpose(-3, -2), stages, q).transpose(-3, -2)


def _overlap_chunks(strategy: str, n_shards: int | None, dim: int) -> int:
    """Number of destination-aligned transpose chunks (1 = unchunked),
    from ALCHEMY_DIST_OVERLAP as in dist.py:251: overlap > 1 splits the
    all_to_all into `overlap` independent exchange+compute chains (default
    off)."""
    nc = int(os.environ.get("ALCHEMY_DIST_OVERLAP", "1"))
    if nc <= 1 or strategy != "a2a" or not n_shards:
        return 1
    while nc > 1 and dim % (n_shards * nc) != 0:
        nc //= 2
    return max(1, nc)


def _dist_ntt_local(x, t, cfg: DistConfig, strategy: str = "a2a",
                    n_shards: int | None = None, mesh=None):
    """x local int64 [..., L_loc, n_loc] in (j2, j1) storage order."""
    xpose = DIST_STRATEGIES[strategy]
    n1 = cfg.n1
    q = t["q"]
    x = x * t["pre"] % q
    lead = x.shape[:-2]
    Lc = x.shape[-2]
    n2_loc = x.shape[-1] // n1
    x = x.reshape(*lead, Lc, n2_loc, n1)
    x = _stages_L(x, t["stage1"], q, cyclic_ntt_stages)   # over j1 → k1pos
    x = (x.reshape(*lead, Lc, n2_loc * n1) * t["tw"] % q).reshape(*lead, Lc, n2_loc, n1)
    nc = _overlap_chunks(strategy, n_shards, n1)
    if nc > 1:
        # destination-aligned chunking: original column c·(nc·ncc) + k·ncc
        # + j lands on rank c either way, so each chunk's exchange is a
        # C-way a2a of a column subset and the concatenated result is
        # bit-identical to the one-shot transpose
        C = n_shards
        ncc = n1 // (C * nc)
        x6 = x.reshape(*lead, Lc, n2_loc, C, nc, ncc)
        chunks = []
        for k in range(nc):
            xk = x6[..., k, :]                  # [..., L, n2_loc, C, ncc]
            yk = _all_to_all(xk, xk.ndim - 2, xk.ndim - 3, mesh)
            yk = yk.reshape(*lead, Lc, n2_loc * C, ncc).transpose(-1, -2)  # [..., L, ncc, n2]
            chunks.append(_stages_L(yk, t["stage2"], q, cyclic_ntt_stages))
        x = torch.cat(chunks, dim=-2)           # [..., L, n1/C, n2]
        return x.reshape(*lead, Lc, -1)
    x = xpose(x, x.ndim - 1, x.ndim - 2, n_shards, mesh)  # [..., L, n2, n1/C]
    x = x.transpose(-1, -2)                               # [..., L, n1/C, n2]
    x = _stages_L(x, t["stage2"], q, cyclic_ntt_stages)   # over j2 → k2pos
    return x.reshape(*lead, Lc, -1)


def _dist_intt_local(x, t, cfg: DistConfig, strategy: str = "a2a",
                     n_shards: int | None = None, mesh=None):
    xpose = DIST_STRATEGIES[strategy]
    n2 = cfg.n2
    q = t["q"]
    lead = x.shape[:-2]
    Lc = x.shape[-2]
    n1_loc = x.shape[-1] // n2
    x = x.reshape(*lead, Lc, n1_loc, n2)
    x = _stages_L(x, t["stage2_inv"], q, cyclic_intt_stages)  # undo over j2
    x = x.transpose(-1, -2)                                   # [..., L, n2, n1/C]
    nc = _overlap_chunks(strategy, n_shards, n2)
    itwv = t["itw"]
    if nc > 1:
        # the forward direction's destination-aligned chunking
        C = n_shards
        ncc = n2 // (C * nc)
        x6 = x.reshape(*lead, Lc, C, nc, ncc, n1_loc)
        itw6 = itwv.reshape(Lc, nc, ncc * C * n1_loc)
        n1 = C * n1_loc
        chunks = []
        for k in range(nc):
            xk = x6[..., k, :, :]               # [..., L, C, ncc, n1_loc]
            yk = _all_to_all(xk, xk.ndim - 3, xk.ndim - 1, mesh)
            yk = yk.reshape(*lead, Lc, ncc * n1)              # [..., L, ncc·n1]
            yk = (yk * itw6[:, k] % q).reshape(*lead, Lc, ncc, n1)
            chunks.append(_stages_L(yk, t["stage1_inv"], q, cyclic_intt_stages))
        x = torch.cat(chunks, dim=-2).reshape(*lead, Lc, -1)  # [..., L, n2/C·n1]
        return x * t["post"] % q
    x = xpose(x, x.ndim - 2, x.ndim - 1, n_shards, mesh)      # [..., L, n2/C, n1]
    n2_loc, n1 = x.shape[-2], x.shape[-1]
    x = (x.reshape(*lead, Lc, -1) * itwv % q).reshape(*lead, Lc, n2_loc, n1)
    x = _stages_L(x, t["stage1_inv"], q, cyclic_intt_stages)  # undo over j1
    return x.reshape(*lead, Lc, -1) * t["post"] % q


def _mul(a, b, q):
    """a·b mod q for any uint32 a, b (dist.py:369): exact in int64. The JAX
    package's `_reduce_u32_local` (:364) is `% q` here, and `_add` (:383)
    is `modarith._add_mod`."""
    return a % q * (b % q) % q


# ---------------------------------------------------------------------------
# the DTensor boundary
# ---------------------------------------------------------------------------


def _local(x, mesh, placements, what: str) -> torch.Tensor:
    """This rank's shard of the DTensor x as int64, after checking that x
    lies on `mesh` with `placements` (nothing is redistributed silently)."""
    if not isinstance(x, DTensor) or x.dtype != torch.int32:
        raise TypeError(f"{what}: want an int32 DTensor, got {type(x).__name__} "
                        f"{getattr(x, 'dtype', '')}")
    if x.device_mesh != mesh or tuple(x.placements) != tuple(placements):
        raise ValueError(f"{what}: placements {tuple(x.placements)} on {x.device_mesh}; "
                         f"want {tuple(placements)} on {mesh}")
    return widen(x.to_local())


def _global(x: torch.Tensor, mesh, placements) -> DTensor:
    return DTensor.from_local(narrow(x), mesh, placements, run_check=False)


def _check_mesh(cfg: DistConfig, mesh, *rows: int) -> None:
    LS, C = _size(mesh, "limb"), _size(mesh, "coeff")
    if any(r % LS for r in rows):
        raise ValueError(f"rows {rows} do not split over {LS} limb shards")
    if cfg.n1 % C or cfg.n2 % C:
        raise ValueError(f"n1={cfg.n1}, n2={cfg.n2} do not split over {C} coefficient shards")


# ---------------------------------------------------------------------------
# the sharded fused step
# ---------------------------------------------------------------------------


def make_dist_mul_relin(cfg: DistConfig, mesh, strategy: str | None = None,
                        hint_placement: str = "digit"):
    """Build the mesh-sharded batched mul+relin (dist.py:392):
    cts [B, 2, L, n] × hints [L, L, n] → [B, 2, L, n], DTensors with
    CT_PLACEMENTS and HINT_PLACEMENTS (or ROW_HINT_PLACEMENTS).

    hint_placement:
    - "digit" (default): hint gadget-row axis replicated, target-limb and
      coefficient axes sharded; one all_gather of the c2 coefficient rows
      over 'limb' per relin. Hint bytes per rank = L·L_loc·n_loc·4.
    - "row": hint GADGET ROWS sharded over 'limb' — each rank holds only
      its own digits' rows (at all target limbs) and computes their digit
      NTTs + partial hint products; one int64 `all_reduce` over 'limb'
      followed by a reduction mod q combines them (the JAX package's
      recursive-doubling mod-q allreduce, dist.py:448-457, gives the same
      residues: both are exact). Hint bytes per rank drop limb_shards×."""
    strategy = strategy or pick_dist_strategy(mesh)
    C = _size(mesh, "coeff")
    LS = _size(mesh, "limb")
    L = len(cfg.p.qs)
    _check_mesh(cfg, mesh, L)
    tabs = _tables_for(cfg, mesh)

    def products(ct_a, ct_b):
        q = tabs["q"]
        a0, a1 = ct_a[:, 0], ct_a[:, 1]
        b0, b1 = ct_b[:, 0], ct_b[:, 1]
        c0 = _mul(a0, b0, q)
        c1 = _add_mod(_mul(a0, b1, q), _mul(a1, b0, q), q)
        c2 = _mul(a1, b1, q)
        return c0, c1, _dist_intt_local(c2, tabs, cfg, strategy, C, mesh)

    if hint_placement == "row":
        if LS & (LS - 1):
            raise ValueError(f"row placement needs a power-of-two limb axis, got {LS}")
        L_loc = L // LS
        ftabs = _tables_for(cfg, mesh, limb_sharded=False)

        def step(ct_a, ct_b, hb, ha):
            q, fq = tabs["q"], ftabs["q"]
            c0, c1, c2_coeff = products(ct_a, ct_b)
            part0 = c2_coeff.new_zeros((c2_coeff.shape[0], L, c2_coeff.shape[-1]))
            part1 = torch.zeros_like(part0)
            for i_loc in range(L_loc):
                row = c2_coeff[:, i_loc:i_loc + 1, :]
                dig = row.expand(part0.shape) % fq
                dig_ntt = _dist_ntt_local(dig, ftabs, cfg, strategy, C, mesh)
                part0 = _add_mod(part0, _mul(dig_ntt, hb[i_loc][None], fq), fq)
                part1 = _add_mod(part1, _mul(dig_ntt, ha[i_loc][None], fq), fq)
            tot = _all_reduce(torch.stack([part0, part1], dim=1), mesh, "limb") % fq
            li = mesh.get_local_rank("limb")
            own = tot[:, :, li * L_loc:(li + 1) * L_loc]
            return torch.stack([_add_mod(c0, own[:, 0], q), _add_mod(c1, own[:, 1], q)], dim=1)

        hint_spec = ROW_HINT_PLACEMENTS
    elif hint_placement == "digit":
        def step(ct_a, ct_b, hb, ha):
            q = tabs["q"]
            c0, c1, c2_coeff = products(ct_a, ct_b)        # c2_coeff [B_loc, L_loc, n_loc]
            rows = _all_gather(c2_coeff, 1, mesh, "limb")  # [B_loc, L, n_loc]
            out0, out1 = c0, c1
            for i in range(L):
                dig = rows[:, i:i + 1, :].expand(c2_coeff.shape) % q
                dig_ntt = _dist_ntt_local(dig, tabs, cfg, strategy, C, mesh)
                out0 = _add_mod(out0, _mul(dig_ntt, hb[i][None], q), q)
                out1 = _add_mod(out1, _mul(dig_ntt, ha[i][None], q), q)
            return torch.stack([out0, out1], dim=1)

        hint_spec = HINT_PLACEMENTS
    else:
        raise ValueError(f"hint_placement={hint_placement!r}: want 'digit' or 'row'")

    def run(ct_a, ct_b, hb, ha):
        out = step(_local(ct_a, mesh, CT_PLACEMENTS, "ct_a"),
                   _local(ct_b, mesh, CT_PLACEMENTS, "ct_b"),
                   _local(hb, mesh, hint_spec, "hint_b"), _local(ha, mesh, hint_spec, "hint_a"))
        return _global(out, mesh, CT_PLACEMENTS)

    return run


def make_dist_mul_relin_hybrid(hk, cfg: DistConfig, mesh, strategy: str | None = None):
    """Mesh-sharded fused multiply + HYBRID relinearization (dist.py:530).

    cts [B, 2, L, n] (dist storage, base chain) × hints [dnum, T, n] (dist
    NTT domain, extended chain Q·P) → [B, 2, L, n], DTensors with
    CT_PLACEMENTS and HINT_PLACEMENTS; hk is the port's
    `she.hybrid.HybridKS`. Garner digits are elementwise per coefficient, so
    'coeff' stays sharded end to end; the base chain (L rows) and the
    extended chain (T = L + K rows) shard over 'limb'. Per op: one
    all_gather of the c2 coefficient rows over 'limb', one all_gather of the
    accumulator coefficients for the joint P-rescale, plus the NTT
    transposes over 'coeff'. Same residues as `she.hybrid.mul_relin_hybrid`
    through the layout bridge."""
    strategy = strategy or pick_dist_strategy(mesh)
    C = _size(mesh, "coeff")
    p, pe = hk.p, hk.pe
    L, T = len(p.qs), len(pe.qs)
    if tuple(cfg.p.qs) != tuple(p.qs):
        raise ValueError("cfg and hk name different chains")
    _check_mesh(cfg, mesh, L, T)
    LS = _size(mesh, "limb")
    L_loc, T_loc = L // LS, T // LS
    cfg_e = DistConfig(p=FastParams(n=p.n, qs=pe.qs, zp=p.zp, impl=p.impl),
                       n1=cfg.n1, n2=cfg.n2)
    tb = _tables_for(cfg, mesh)
    te = _tables_for(cfg_e, mesh)
    dev = tb["q"].device
    li = mesh.get_local_rank("limb")
    rows_b = slice(li * L_loc, (li + 1) * L_loc)
    rows_e = slice(li * T_loc, (li + 1) * T_loc)

    drop = hk.ps
    P_int = 1
    for g in drop:
        P_int *= g
    pz = p.zp
    if pz & (pz - 1) or pz > (1 << 16):
        raise ValueError("hybrid relinearization needs a power-of-two zp <= 2^16")

    def col(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)[..., None]

    # per-group base-extension weights to my extended rows ([α, T_loc, 1]),
    # the dropped chain's weights to my base rows ([K, L_loc, 1])
    ext_w = [col(_extend_consts(grp, pe.qs)[:, rows_e]) for grp in hk.groups]
    wd = col(_extend_consts(drop, p.qs)[:, rows_b])
    P_mod = col([P_int % q for q in p.qs[rows_b]])
    invP = col([pow(P_int % q, -1, q) for q in p.qs[rows_b]])

    def step(ct_a, ct_b, hb, ha):
        qb, qe = tb["q"], te["q"]
        a0, a1 = ct_a[:, 0], ct_a[:, 1]
        b0, b1 = ct_b[:, 0], ct_b[:, 1]
        c0 = _mul(a0, b0, qb)
        c1 = _add_mod(_mul(a0, b1, qb), _mul(a1, b0, qb), qb)
        c2 = _mul(a1, b1, qb)
        c2_coeff = _dist_intt_local(c2, tb, cfg, strategy, C, mesh)
        rows = _all_gather(c2_coeff, 1, mesh, "limb")

        # Garner digits per group (identical on every limb shard), extended
        # to my own extended rows
        digs = []
        off = 0
        for gi, grp in enumerate(hk.groups):
            xs = garner_digits(rows[:, off:off + len(grp), :], grp)
            off += len(grp)
            d = None
            for k, x in enumerate(xs):
                term = x[:, None, :] * ext_w[gi][k] % qe
                d = term if d is None else _add_mod(d, term, qe)
            digs.append(d)                       # [B, T_loc, n_loc]
        dig_ntt = _dist_ntt_local(torch.stack(digs, dim=1), te, cfg_e, strategy, C, mesh)

        t0 = t1 = None
        for j in range(len(hk.groups)):
            d = dig_ntt[:, j]
            u0 = _mul(d, hb[j][None], qe)
            u1 = _mul(d, ha[j][None], qe)
            t0 = u0 if t0 is None else _add_mod(t0, u0, qe)
            t1 = u1 if t1 is None else _add_mod(t1, u1, qe)

        # joint P-rescale, distributed (she/hybrid._rescale_joint math)
        coeff = _dist_intt_local(torch.stack([t0, t1], dim=1), te, cfg_e, strategy, C, mesh)
        full = _all_gather(coeff, 2, mesh, "limb")          # [B, 2, T, n_loc]
        xs = garner_digits(full[:, :, L:, :], drop)
        is_neg, tt, t_neg = _sign_terms(xs, drop, pz)
        cj = full[:, :, rows_b]
        v = None
        for k, x in enumerate(xs):
            term = x[..., None, :] * wd[k] % qb
            v = term if v is None else _add_mod(v, term, qb)
        vq = torch.where(is_neg[..., None, :],
                         torch.where(v >= P_mod, v - P_mod, v + qb - P_mod), v)
        ttb = tt[..., None, :]
        tc = torch.where(t_neg[..., None, :], qb - (pz - ttb), ttb)
        delta = _cond_sub(vq + tc * P_mod % qb, qb)
        diff = torch.where(cj >= delta, cj - delta, cj + qb - delta)
        out01 = _dist_ntt_local(diff * invP % qb, tb, cfg, strategy, C, mesh)
        return torch.stack([_add_mod(c0, out01[:, 0], qb), _add_mod(c1, out01[:, 1], qb)], dim=1)

    def run(ct_a, ct_b, hb, ha):
        out = step(_local(ct_a, mesh, CT_PLACEMENTS, "ct_a"),
                   _local(ct_b, mesh, CT_PLACEMENTS, "ct_b"),
                   _local(hb, mesh, HINT_PLACEMENTS, "hint_b"),
                   _local(ha, mesh, HINT_PLACEMENTS, "hint_a"))
        return _global(out, mesh, CT_PLACEMENTS)

    return run


def make_dist_rescale(cfg: DistConfig, mesh, active: int, strategy: str | None = None):
    """Mesh-sharded exact BGV rescale dropping limb `active-1` of the PADDED
    chain (dist.py:702; she/fast.rescale semantics, one limb).

    The ciphertext stays at the full allocation [B, 2, L0, n] (a DTensor
    with CT_PLACEMENTS) with rows ≥ active zeroed; returns the same shape
    with row active-1 dropped (zeroed) and rows < active-1 exactly
    rescaled. Cross-rank traffic: one all_reduce broadcasting the dropped
    limb's coefficient row over 'limb', plus the NTT all_to_alls over
    'coeff'."""
    strategy = strategy or pick_dist_strategy(mesh)
    C = _size(mesh, "coeff")
    p = cfg.p
    qs = p.qs
    L0 = len(qs)
    if not 2 <= active <= L0:
        raise ValueError(f"active={active}: want 2 <= active <= {L0}")
    qk = qs[active - 1]
    pz = p.zp
    if pz & (pz - 1):
        raise ValueError("rescale needs a power-of-two plaintext modulus")
    _check_mesh(cfg, mesh, L0)
    t = _tables_for(cfg, mesh)
    L_loc = L0 // _size(mesh, "limb")
    li = mesh.get_local_rank("limb")
    mine = range(li * L_loc, (li + 1) * L_loc)
    dev = t["q"].device

    def col(vals):
        return torch.tensor(vals, dtype=torch.int64, device=dev)[:, None]

    keep = col([int(j < active - 1) for j in mine])
    qk_mod = col([qk % qs[j] if j < active - 1 else 0 for j in mine])
    inv_qk = col([pow(qk, -1, qs[j]) if j < active - 1 else 1 for j in mine])
    sel = col([int(j == active - 1) for j in mine])
    half, mask = qk // 2, pz - 1
    qk_mod_p, inv_qk_p = qk % pz, pow(qk, -1, pz)

    def step(ct):
        q = t["q"]
        coeff = _dist_intt_local(ct, t, cfg, strategy, C, mesh)   # [B, 2, L_loc, n_loc]
        r = _all_reduce((coeff * sel).sum(dim=-2), mesh, "limb")   # [B, 2, n_loc]
        is_neg = r > half
        r_mod_p = r & mask
        rc_mod_p = torch.where(is_neg, (r_mod_p + pz - (qk_mod_p & mask)) & mask, r_mod_p)
        tt = (((pz - rc_mod_p) & mask) * inv_qk_p) & mask
        t_neg = tt > pz // 2
        r_red = r[..., None, :] % q
        rc = torch.where(is_neg[..., None, :],
                         torch.where(r_red >= qk_mod, r_red - qk_mod, r_red + q - qk_mod),
                         r_red)
        ttb = tt[..., None, :]
        tc = torch.where(t_neg[..., None, :], q - (pz - ttb), ttb)
        delta = _cond_sub(rc + tc * qk_mod % q, q)
        diff = torch.where(coeff >= delta, coeff - delta, coeff + q - delta)
        out = diff * inv_qk % q * keep
        return _dist_ntt_local(out, t, cfg, strategy, C, mesh)

    def run(ct):
        return _global(step(_local(ct, mesh, CT_PLACEMENTS, "ct")), mesh, CT_PLACEMENTS)

    return run


def make_dist_ntt(cfg: DistConfig, mesh, strategy: str | None = None):
    """Sharded forward/inverse negacyclic NTT on [B, L, n] DTensors with
    NTT_PLACEMENTS (dist.py:793). `strategy` picks the DistNTT transpose:
    'a2a' (one tiled all_to_all) or 'ring' (C-1 staged ppermute rounds)."""
    strategy = strategy or pick_dist_strategy(mesh)
    if strategy not in DIST_STRATEGIES:
        raise ValueError(f"strategy={strategy!r}: want one of {sorted(DIST_STRATEGIES)}")
    C = _size(mesh, "coeff")
    _check_mesh(cfg, mesh, len(cfg.p.qs))
    t = _tables_for(cfg, mesh)

    def fwd(x):
        y = _dist_ntt_local(_local(x, mesh, NTT_PLACEMENTS, "x"), t, cfg, strategy, C, mesh)
        return _global(y, mesh, NTT_PLACEMENTS)

    def inv(x):
        y = _dist_intt_local(_local(x, mesh, NTT_PLACEMENTS, "x"), t, cfg, strategy, C, mesh)
        return _global(y, mesh, NTT_PLACEMENTS)

    return fwd, inv
