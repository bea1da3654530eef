"""The general-cyclotomic backend sharded over a ('limb', 'coeff') mesh: how
`interp/jit_exec.jit_compile(..., mesh=)` runs a whole compiled program on
the ranks of a `torch.distributed` world.

The JAX package annotates a program's inputs and hoisted hints with
`_auto_sharding` and lets GSPMD partition the traced evaluator
(`alchemy_tpu/interp/jit_exec.py:90`). Torch has no GSPMD, and DTensor
propagation cannot see through `TorchBackend`'s int64 `%`, its float64
half-word matmuls and its host round trips. So the partition is explicit
here: `ShardedTorchBackend` has `TorchBackend`'s method set, its arrays are
`ShardArray`s, this rank's block of a logical residue array, and each method
computes `TorchBackend`'s function on its block, doing exactly the
collective it needs:

- local, no collective: add, sub, neg, mul, mul_const, sum_terms, zeros,
  stack_rows, asarray, reduce_signed, broadcast_row (each rank keeps its
  slice of a host array);
- across 'limb' (one all_gather of the rows, `TorchBackend`'s own code on
  them, then this rank's rows of the result): rescale_step (needs limb
  q_k), modswitch_up (the output's blocks differ from the input's),
  gadget_digit_rows (digit i is limb i's residues) and hybrid_digit_rows
  (Garner over a limb group);
- across 'coeff': axis_matmul, whose transforms run along the ring's tensor
  factors: one all_gather of the coefficients, the transform of this rank's
  limbs, then this rank's coefficients of the result. A reshape or
  permutation that moves the coefficient axis (`Cyc`'s batched transforms,
  `rel_coeffs`) gathers it the same way and leaves the array whole along
  it; the next elementwise op slices it again, which costs nothing;
- on the host: to_numpy and lift_centered gather the whole array, and
  `full` gathers it on the device (the noise probe's digits).

Layout (the JAX package's `_auto_sharding` and `_pad_rows`, jit_exec.py:90,
:412). An array's limb axis (axis 0 of a [L, n] residue array, axis 1 of
the [D, L, n] digit rows) is either sharded over 'limb' or whole; its last
axis, the flattened coefficients, is sharded over 'coeff' when its length
divides that axis, else whole. A sharded limb axis of length L is split in
blocks of b = ⌈L / LS⌉ rows (LS = the 'limb' axis): rank li holds rows
[li·b, (li + 1)·b), zero-padded past L. That is torch.chunk's split,
DTensor's `Shard` on an uneven dimension, and the JAX package's padded
layout. Chain lengths change inside a program (a rescale drops a limb,
`modswitch_up` adds limbs); every op lays its output out by this rule for
the output's own length. The padded rows hold 0 and have the modulus 1 in
every elementwise op, so they stay 0; a limb-crossing op strips them before
it reads the rows. Other mesh axes ('batch') replicate.

Every collective is an all_gather through `parallel/dist.py`'s `_staged`
(gloo's CUDA tensors staged through host memory; residues moved as int32)
and is counted in
`collectives` by (op, mesh axis) and in `comm_ops` by the backend method
that made it. An axis of one rank does no collective.
"""

from __future__ import annotations

import warnings
from collections import Counter
from math import prod

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.parallel import dist as D


class ShardingFallbackWarning(UserWarning):
    """An input axis could not be sharded over its mesh axis and was left
    replicated (jit_exec.py:83: never silently). jit_compile's limb padding
    removes the limb-axis case; a coefficient axis not divisible by the
    'coeff' mesh axis still warns."""


def mesh_dims(mesh) -> dict:
    """{axis name: size} of a DeviceMesh (the JAX `mesh.shape`)."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names or ())}


def layout_for(shape: tuple, mesh, pad: bool = False, warn: bool = True) -> tuple[bool, bool]:
    """(limb sharded, coefficient sharded) for a [L, n_flat] residue array
    on `mesh`, by the JAX rule (jit_exec.py:90): limb-TP when L divides the
    'limb' axis (always, with `pad`), coefficient-SP when n_flat divides
    'coeff'; otherwise that axis is replicated, with a
    ShardingFallbackWarning when `warn`."""
    dims = mesh_dims(mesh)
    LS, C = dims.get("limb", 1), dims.get("coeff", 1)
    lsh = csh = True
    if LS > 1 and shape[0] % LS and not pad:
        lsh = False
        if warn and shape[0] > 1:
            warnings.warn(f"limb axis of length {shape[0]} not divisible by mesh "
                          f"'limb'={LS}; replicating that axis",
                          ShardingFallbackWarning, stacklevel=3)
    if C > 1 and shape[-1] % C:
        csh = False
        if warn:
            warnings.warn(f"coefficient axis of length {shape[-1]} not divisible by mesh "
                          f"'coeff'={C}; replicating that axis",
                          ShardingFallbackWarning, stacklevel=3)
    return lsh, csh


def placements(mesh, lsh: bool, csh: bool) -> tuple:
    """The placements, one per mesh dimension, of a [L, n_flat] layout."""
    return tuple(Shard(0) if name == "limb" and lsh
                 else Shard(1) if name == "coeff" and csh else Replicate()
                 for name in mesh.mesh_dim_names)


class ShardArray:
    """This rank's block of a logical int64 residue array of `shape`
    (global, unpadded): `local` holds the rows of the limb axis `la` that
    this rank owns (all of them when `lsh` is false) and the coefficient
    block of the last axis (all of it when `csh` is false). It answers the
    array reads `core/cyc.py` makes (shape, reshape, permute, indexing) in
    logical terms; a reshape, permutation or index that moves the
    coefficient axis gathers it first."""

    __slots__ = ("bk", "local", "shape", "la", "lsh", "csh")

    def __init__(self, bk, local, shape, la: int = 0, lsh: bool = True, csh: bool = True):
        self.bk, self.local, self.shape = bk, local, tuple(shape)
        self.la, self.lsh, self.csh = la, lsh, csh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def __repr__(self):
        return (f"ShardArray(shape={self.shape}, la={self.la}, lsh={self.lsh}, "
                f"csh={self.csh}, local={tuple(self.local.shape)})")

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if -1 in shape:
            i = shape.index(-1)
            rest = prod(s for s in shape if s != -1)
            shape = (*shape[:i], prod(self.shape) // rest, *shape[i + 1:])
        if tuple(shape) == self.shape:
            return self
        if self.la != 0 or shape[0] != self.shape[0]:
            raise NotImplementedError(f"{self}: a reshape to {shape} moves the limb axis")
        x = self.bk._whole_coeff(self, "reshape") if shape[-1] != self.shape[-1] else self
        last = x.local.shape[-1] if shape[-1] == self.shape[-1] else shape[-1]
        local = x.local.reshape(x.local.shape[0], *shape[1:-1], last)
        return ShardArray(self.bk, local, shape, 0, x.lsh, x.csh)

    def permute(self, perm):
        perm = tuple(perm)
        x = self.bk._whole_coeff(self, "permute") if perm[-1] != self.ndim - 1 else self
        return ShardArray(self.bk, x.local.permute(perm), tuple(self.shape[p] for p in perm),
                          perm.index(self.la), x.lsh, x.csh)

    def __getitem__(self, idx):
        idx = idx if isinstance(idx, tuple) else (idx,)
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        full = slice(None)
        if idx[self.la] != full:
            raise NotImplementedError(f"{self}: indexing the limb axis with {idx[self.la]}")
        x = self.bk._whole_coeff(self, "index") if idx[-1] != full else self
        shape = torch.empty(self.shape, device="meta")[idx].shape
        la = self.la - sum(isinstance(i, int) for i in idx[:self.la])
        return ShardArray(self.bk, x.local[idx], shape, la, x.lsh, x.csh)


class ShardedTorchBackend:
    """`TorchBackend`'s protocol on `ShardArray`s over the 'limb' and
    'coeff' axes of `mesh` (a DeviceMesh of the initialised world; other
    axes replicate). Each method computes on this rank's block with an inner
    `TorchBackend` on the mesh's device (`tb`), whose `counts` this
    backend shares. `limb_pad=False` leaves a chain that does not divide
    'limb' replicated at the program's entry (with a warning), as the JAX
    package does; inside the program the padded layout holds either way."""

    name = "torch_sharded"

    def __init__(self, mesh, limb_pad: bool = True):
        self.mesh = mesh
        self.limb_pad = limb_pad
        self.device = D._device(mesh)
        self.tb = TorchBackend(self.device)
        self.counts = self.tb.counts
        dims = mesh_dims(mesh)
        self.LS, self.C = dims.get("limb", 1), dims.get("coeff", 1)
        self.li = mesh.get_local_rank("limb") if self.LS > 1 else 0
        self.ci = mesh.get_local_rank("coeff") if self.C > 1 else 0
        #: collective calls by (op, mesh axis), and by the method that made them
        self.collectives: Counter = Counter()
        self.comm_ops: Counter = Counter()
        self._qloc: dict = {}

    def reset_collectives(self) -> None:
        self.collectives.clear()
        self.comm_ops.clear()

    # -- layout -------------------------------------------------------------

    def block(self, L: int) -> tuple[int, int, int]:
        """(b, lo, hi): this rank's block size and its real rows [lo, hi) of
        a sharded limb axis of length L."""
        b = -(-L // self.LS)
        lo = min(self.li * b, L)
        return b, lo, min(lo + b, L)

    def _cblock(self, N: int) -> slice:
        w = N // self.C
        return slice(self.ci * w, (self.ci + 1) * w)

    def _split_limb(self, t: torch.Tensor, L: int, la: int) -> torch.Tensor:
        """Rows [lo, hi) of the whole limb axis la of t, zero-padded to b."""
        b, lo, hi = self.block(L)
        x = t.narrow(la, lo, hi - lo)
        if hi - lo < b:
            pad = list(x.shape)
            pad[la] = b - (hi - lo)
            x = torch.cat((x, x.new_zeros(pad)), dim=la)
        return x

    def shard(self, t: torch.Tensor, lsh: bool = True, csh: bool = True, la: int = 0) -> ShardArray:
        """This rank's block of a whole tensor t (any device) with the layout
        (lsh, csh), on the mesh's device; a flag is dropped where the axis
        does not split (coefficients) or has one rank."""
        shape = tuple(t.shape)
        csh = csh and shape[-1] % self.C == 0
        x = self._split_limb(t, shape[la], la) if lsh and self.LS > 1 else t
        if csh and self.C > 1:
            x = x[..., self._cblock(shape[-1])]
        return ShardArray(self, x.contiguous().to(self.device), shape, la,
                          lsh or self.LS == 1, csh or self.C == 1)

    def layout(self, shape: tuple, warn: bool = True) -> tuple[bool, bool]:
        """The entry layout of a [L, n_flat] array (`layout_for` on this
        backend's mesh and limb padding)."""
        return layout_for(shape, self.mesh, pad=self.limb_pad, warn=warn)

    def _sharded(self, x: ShardArray, lsh: bool, csh: bool) -> ShardArray:
        """x with each axis that `lsh`/`csh` asks for sharded: a whole axis
        is sliced locally (no collective)."""
        t = x.local
        if lsh and not x.lsh:
            t = self._split_limb(t, x.shape[x.la], x.la)
        csh = csh and x.shape[-1] % self.C == 0
        if csh and not x.csh:
            t = t[..., self._cblock(x.shape[-1])]
        return ShardArray(self, t, x.shape, x.la, x.lsh or lsh, x.csh or csh)

    def canonical(self, x: ShardArray) -> ShardArray:
        """x with both axes sharded where they split."""
        return self._sharded(x, True, True)

    def _align(self, xs):
        """The arrays with a common layout: an axis sharded in any of them
        is sharded in all."""
        lsh, csh = any(x.lsh for x in xs), any(x.csh for x in xs)
        return [self._sharded(x, lsh, csh) for x in xs], lsh, csh

    def _q(self, qs, lsh: bool) -> torch.Tensor:
        """The moduli column of this rank's rows ([b, 1] with 1 on padded
        rows when sharded, [L, 1] otherwise)."""
        key = (tuple(qs), lsh)
        if key not in self._qloc:
            if lsh:
                b, lo, hi = self.block(len(qs))
                vals = list(qs[lo:hi]) + [1] * (b - (hi - lo))
            else:
                vals = list(qs)
            self._qloc[key] = torch.tensor(vals, dtype=torch.int64, device=self.device)[:, None]
        return self._qloc[key]

    # -- collectives ----------------------------------------------------------

    def _gather(self, t: torch.Tensor, dim: int, axis: str, op: str) -> torch.Tensor:
        """The blocks of t of every rank of `axis`, concatenated along dim in
        rank order: one all_gather of the stacked blocks, moved as int32
        (residues are below 2^31, so the cast is exact)."""
        self.collectives["all_gather", axis] += 1
        self.comm_ops[op] += 1
        group, A = self.mesh.get_group(axis), self.LS if axis == "limb" else self.C

        def gather(u):
            out = u.new_empty((A * u.shape[0], *u.shape[1:]))
            dist.all_gather_into_tensor(out, u, group=group)
            return out.view(A, *u.shape)

        g = D._staged(t.to(torch.int32).contiguous(), group, "all_gather", axis, gather)
        return g.movedim(0, dim).flatten(dim, dim + 1).to(torch.int64)

    def _whole_coeff(self, x: ShardArray, op: str) -> ShardArray:
        """x with its coefficient axis whole (one all_gather over 'coeff')."""
        if x.csh and self.C > 1:
            t = self._gather(x.local, x.local.ndim - 1, "coeff", op)
            return ShardArray(self, t, x.shape, x.la, x.lsh, False)
        return x

    def _whole_rows(self, x: ShardArray, op: str) -> torch.Tensor:
        """x's local tensor with every real row of its limb axis (one
        all_gather over 'limb', padding stripped)."""
        if x.lsh and self.LS > 1:
            return self._gather(x.local, x.la, "limb", op).narrow(x.la, 0, x.shape[x.la])
        return x.local

    def full(self, x: ShardArray) -> torch.Tensor:
        """The whole logical array on this rank's device (collectives over
        both axes)."""
        return self._whole_rows(self._whole_coeff(x, "full"), "full")

    # -- construction ---------------------------------------------------------

    def asarray(self, arr, qs: tuple[int, ...]) -> ShardArray:
        a = np.asarray(arr, dtype=np.int64)
        if a.ndim == 1:
            a = np.broadcast_to(a[None, :], (len(qs), a.shape[0]))
        shape = a.shape
        lsh, csh = True, shape[-1] % self.C == 0
        b, lo, hi = self.block(shape[0])
        a = a[lo:hi]
        if csh:
            a = a[:, self._cblock(shape[-1])]
        a = a % np.asarray(qs[lo:hi], dtype=np.int64)[:, None]
        if hi - lo < b:
            a = np.concatenate((a, np.zeros((b - (hi - lo), a.shape[1]), np.int64)))
        self.counts["to_device"] += 1
        t = torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return ShardArray(self, t, shape, 0, lsh, csh or self.C == 1)

    def to_numpy(self, a) -> np.ndarray:
        self.counts["to_host"] += 1
        return self.full(a).cpu().numpy().astype(np.int64)

    def zeros(self, nlimb: int, n: int) -> ShardArray:
        b = self.block(nlimb)[0]
        csh = n % self.C == 0
        t = torch.zeros((b, n // self.C if csh else n), dtype=torch.int64, device=self.device)
        return ShardArray(self, t, (nlimb, n), 0, True, csh or self.C == 1)

    # -- elementwise mod-q (local) --------------------------------------------

    def _elementwise(self, fn, xs, qs):
        xs, lsh, csh = self._align(xs)
        q = self._q(qs, lsh)
        return ShardArray(self, fn(*(x.local for x in xs), q), xs[0].shape, 0, lsh, csh)

    def add(self, a, b, qs):
        return self._elementwise(lambda x, y, q: (x + y) % q, (a, b), qs)

    def sub(self, a, b, qs):
        return self._elementwise(lambda x, y, q: (x - y) % q, (a, b), qs)

    def neg(self, a, qs):
        return self._elementwise(lambda x, q: (-x) % q, (a,), qs)

    def mul(self, a, b, qs):
        return self._elementwise(lambda x, y, q: x * y % q, (a, b), qs)

    def mul_const(self, a, consts, qs):
        """Multiply limb l by scalar consts[l] mod qs[l]."""
        c = self._q(tuple(int(c) % q for c, q in zip(consts, qs)), a.lsh)
        return self._elementwise(lambda x, q: x * c % q, (a,), qs)

    def sum_terms(self, terms, qs):
        def total(*ts):
            q = ts[-1]
            acc = ts[0]
            for t in ts[1:-1]:
                acc = acc + t
            return acc % q

        return self._elementwise(total, list(terms), qs)

    def stack_rows(self, rows):
        rows, lsh, csh = self._align(list(rows))
        r = rows[0]
        return ShardArray(self, torch.stack([x.local for x in rows]), (len(rows), *r.shape),
                          r.la + 1, lsh, csh)

    # -- across 'coeff' --------------------------------------------------------

    def axis_matmul(self, a, mats, shape, qs):
        """`TorchBackend.axis_matmul` of this rank's limbs, on the whole
        coefficient axis (one all_gather over 'coeff' when it is sharded),
        then this rank's coefficients of the result."""
        qs = tuple(qs)
        x = self._sharded(a, True, False)
        sharded_in = x.csh
        x = self._whole_coeff(x, "axis_matmul")
        b, lo, hi = self.block(len(qs))
        if hi > lo:
            def rows(m):
                return list(m)[lo:hi] if isinstance(m, (list, tuple)) else m

            out = self.tb.axis_matmul(x.local[:hi - lo], [rows(m) for m in mats], shape, qs[lo:hi])
        else:
            n_out = prod(s if m is None else (m[0] if isinstance(m, (list, tuple)) else m).shape[0]
                         for m, s in zip(mats, shape))
            out = x.local.new_zeros((0, n_out))
            self.counts["axis_matmul"] += 1
        if hi - lo < b:
            out = torch.cat((out, out.new_zeros((b - (hi - lo), out.shape[1]))))
        y = ShardArray(self, out, (len(qs), out.shape[1]), 0, True, self.C == 1)
        return self._sharded(y, True, True) if sharded_in else y

    # -- across 'limb' ----------------------------------------------------------

    def _limb_op(self, op: str, x: ShardArray, fn, la: int = 0) -> ShardArray:
        """fn (a TorchBackend method) on every real row of x (one all_gather
        over 'limb'), then this rank's rows of the result's limb axis la."""
        out = fn(self._whole_rows(x, op))
        shape = (*out.shape[:-1], x.shape[-1])
        local = self._split_limb(out, out.shape[la], la) if self.LS > 1 else out
        return ShardArray(self, local, shape, la, True, x.csh)

    def rescale_step(self, data, qs, zp):
        return self._limb_op("rescale_step", data,
                             lambda t: self.tb.rescale_step(t, qs, zp))

    def modswitch_up(self, data, old_qs, new_qs):
        return self._limb_op("modswitch_up", data,
                             lambda t: self.tb.modswitch_up(t, old_qs, new_qs))

    def hybrid_digit_rows(self, data, qs, groups, ext_qs):
        return self._limb_op("hybrid_digit_rows", data,
                             lambda t: self.tb.hybrid_digit_rows(t, qs, groups, ext_qs), la=1)

    def gadget_digit_rows(self, data, qs, base):
        return self._limb_op("gadget_digit_rows", data,
                             lambda t: self.tb.gadget_digit_rows(t, qs, base), la=1)

    # -- host round trips -------------------------------------------------------

    def lift_centered(self, a, qs):
        arr = self.to_numpy(a)
        q = np.asarray(qs, dtype=np.int64)[:, None]
        return np.where(arr > q // 2, arr - q, arr)

    def reduce_signed(self, a_signed, qs):
        return self.asarray(np.asarray(a_signed, dtype=np.int64), qs)

    def broadcast_row(self, row, nlimb, qs):
        r = np.asarray(row, dtype=np.int64)
        return self.asarray(np.broadcast_to(r[None, :], (nlimb, r.shape[0])), qs)
