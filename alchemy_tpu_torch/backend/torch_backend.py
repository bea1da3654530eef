"""General-cyclotomic backend on torch: exact mod-q arithmetic on int64
tensors, on the card by default (port of `alchemy_tpu/backend/xla.py:216
XlaBackend`, the same 18-method protocol as `backend/golden.py`).

Residues are stored as int64 tensors holding canonical values in [0, q),
as the golden backend stores them, and every method takes and returns
canonical residues (the mod-q kernels rely on it and do not check it: a
residue outside [0, q) gives a wrong result on the card). Every q is below
2^31, so a product of two residues is below 2^62 and each elementwise op is
exact (the uint32 lane tricks of the JAX backend are not needed). On the
card each mod-q chain is one launch of a kernel of `cuda/modq.py` (`add`,
`sub`, `neg`, `mul`, `mul_const`, `rescale_step`, `modswitch_up`; and
`sum_terms`, which no path calls, one launch a term); on the CPU their plain
versions, the same torch ops as before, run.

`axis_matmul` applies per-axis transform matrices (CRT, iCRT, embeddings,
twaces, decoding-basis changes) along the tensor axes of R_m. Adjacent axes
are merged into Kronecker products while both merged dimensions stay
≤ `_KRON_LIMIT` (the merge of `xla.py:311-382`), which cuts the number of
contractions. Torch has no int64 matmul on CUDA, so each contraction runs
exactly in float64 on `torch.matmul`: the matrix and the operand are split
into 16-bit halves, and one matmul of [W_lo; W_hi] against [x_lo | x_hi]
gives the four partial products. Each partial sum is below
K·(2^16 − 1)^2 < 2^53 for a contraction length K ≤ 2^21, so it is exact in
any order of summation; each is reduced mod q before the halves are
recombined with 2^16 and 2^32 mod q. On the card the split is one launch
(`modq.split16`, reading the operand's axes through their strides) and the
reduction and recombination another (`modq.recombine`, writing the result
with the contracted axis in place, so nothing is copied between
contractions). The CPU runs the same route with torch ops.

`lift_centered`, `reduce_signed`, `broadcast_row` and `to_numpy` go through
host numpy, as in the JAX backend. `counts` records the calls of
`axis_matmul`, the copies between host and device, and the transform
matrices uploaded to the device (cached by content).
"""

from __future__ import annotations

from collections import Counter
from math import prod

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import modq
from alchemy_tpu_torch.backend.modarith import extend_digits, garner_digits, qcol

#: largest contraction length whose float64 partial sums stay exact:
#: 2^21·(2^16 − 1)^2 < 2^53
_MAX_K = 1 << 21


def _matmul_mod(W: torch.Tensor, x: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    """W·x mod q per limb along x's axis K, exact: W [L, 2·d_out, K] float64
    holding the 16-bit halves [W_lo; W_hi] of a canonical matrix, x
    [L, A, K, B] int64 canonical residues, any strides → [L, A, d_out, B]
    int64 in [0, q)."""
    L, A, K, B = x.shape
    if K > _MAX_K:
        raise ValueError(f"axis_matmul: contraction length {K} > {_MAX_K} is not exact in float64")
    return modq.recombine(torch.matmul(W, modq.split16(x)), qs, A, B)


class TorchBackend:
    name = "torch"

    #: combined-axis cap for the Kronecker merge (xla.py:307)
    _KRON_LIMIT = 128

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchBackend(device={device!r}): no CUDA device")
        self._mat_cache: dict = {}
        self._kron_cache: dict = {}
        #: "axis_matmul" calls, "to_host" and "to_device" copies of residues,
        #: "mat_upload"s of transform matrices (once per matrix and moduli)
        self.counts: Counter = Counter()
        #: when a list, axis_matmul appends (L, d_in, d_out, R) per matrix it
        #: applies: L·d_out·d_in·R base MACs each, 4× that in float64 MACs
        #: (the exact-MAC ledger of scripts/profile_examples.py, xla.py:27)
        self.mac_log: list | None = None

    # -- construction -------------------------------------------------------

    def asarray(self, arr, qs: tuple[int, ...]) -> torch.Tensor:
        a = np.asarray(arr, dtype=np.int64)
        if a.ndim == 1:
            a = np.broadcast_to(a[None, :], (len(qs), a.shape[0]))
        a = a % np.asarray(qs, dtype=np.int64)[:, None]
        self.counts["to_device"] += 1
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def to_numpy(self, a) -> np.ndarray:
        self.counts["to_host"] += 1
        return a.detach().cpu().numpy().astype(np.int64)

    def zeros(self, nlimb: int, n: int) -> torch.Tensor:
        return torch.zeros((nlimb, n), dtype=torch.int64, device=self.device)

    # -- elementwise mod-q --------------------------------------------------

    def add(self, a, b, qs):
        return modq.binop("add", a, b, qs)

    def sub(self, a, b, qs):
        return modq.binop("sub", a, b, qs)

    def neg(self, a, qs):
        return modq.binop("neg", a, None, qs)

    def mul(self, a, b, qs):
        return modq.binop("mul", a, b, qs)

    def mul_const(self, a, consts, qs):
        """Multiply limb l by scalar consts[l] mod qs[l]."""
        return modq.scale_pad(a, consts, qs, len(qs))

    def sum_terms(self, terms, qs):
        return modq.sum_terms(terms, qs)

    # -- per-axis transforms ------------------------------------------------

    def _mat_halves(self, mat, qs: tuple[int, ...]) -> torch.Tensor:
        """[L, 2·d_out, d_in] float64 16-bit halves of the per-limb (or
        shared) matrix reduced mod q, on the device, cached by content."""
        per_limb = isinstance(mat, (list, tuple))
        mats = list(mat) if per_limb else [mat] * len(qs)
        key = (qs, tuple(m.tobytes() for m in mats), mats[0].shape)
        out = self._mat_cache.get(key)
        if out is None:
            W = np.stack([np.asarray(m, dtype=np.int64) % q for m, q in zip(mats, qs)])
            halves = np.concatenate((W & 0xFFFF, W >> 16), axis=1).astype(np.float64)
            out = torch.from_numpy(halves).to(self.device)
            self._mat_cache[key] = out
            self.counts["mat_upload"] += 1
        return out

    def _merge_axis_mats(self, mats, shape, qs: tuple[int, ...]):
        """Greedy Kronecker merge of ADJACENT transform axes while the
        combined dimensions stay ≤ _KRON_LIMIT (xla.py:311): kron(W1, W2)
        applied to the flattened (ax, ax+1) index computes the same exact
        mod-q values in one contraction instead of two.

        Returns [(n_axes_spanned, merged_mat_or_None, d_in, d_out)]."""
        groups = []
        i = 0

        def din(m):
            return (m[0] if isinstance(m, (list, tuple)) else m).shape[1]

        def dout(m):
            return (m[0] if isinstance(m, (list, tuple)) else m).shape[0]

        while i < len(mats):
            if mats[i] is None:
                groups.append((1, None, shape[i], shape[i]))
                i += 1
                continue
            cur = mats[i]
            si, so = din(cur), dout(cur)
            span = 1
            while (i + span < len(mats) and mats[i + span] is not None
                   and si * din(mats[i + span]) <= self._KRON_LIMIT
                   and so * dout(mats[i + span]) <= self._KRON_LIMIT):
                nxt = mats[i + span]
                cur = self._kron_pair(cur, nxt, qs)
                si *= din(nxt)
                so *= dout(nxt)
                span += 1
            groups.append((span, cur, si, so))
            i += span
        return groups

    def _kron_pair(self, m1, m2, qs: tuple[int, ...]):
        """Per-limb (or shared) Kronecker product, reduced mod q, cached by
        content (xla.py:352)."""

        def mat_key(m):
            if isinstance(m, (list, tuple)):
                return tuple((x.shape, x.tobytes()) for x in m)
            return (m.shape, m.tobytes())

        key = (mat_key(m1), mat_key(m2), qs)
        out = self._kron_cache.get(key)
        if out is None:
            p1 = isinstance(m1, (list, tuple))
            p2 = isinstance(m2, (list, tuple))
            if p1 or p2:
                l1 = list(m1) if p1 else [m1] * len(qs)
                l2 = list(m2) if p2 else [m2] * len(qs)
                out = [
                    np.kron(a.astype(np.int64) % q, b.astype(np.int64) % q) % q
                    for a, b, q in zip(l1, l2, qs)
                ]
            else:
                out = np.kron(m1.astype(np.int64), m2.astype(np.int64))
            self._kron_cache[key] = out
        return out

    def axis_matmul(self, a, mats, shape, qs):
        """Apply per-axis matrices along the tensor axes of a [L, n] array
        (golden.py `axis_matmul`): mats[i] is None, a [d_out, d_in] matrix
        shared by all limbs, or a list of per-limb matrices."""
        qs = tuple(qs)
        self.counts["axis_matmul"] += 1
        L = a.shape[0]
        groups = self._merge_axis_mats(list(mats), list(shape), qs)
        dims = []
        pos = 0
        for span, _mat, _d_in, _d_out in groups:
            dims.append(prod(shape[pos:pos + span]))
            pos += span
        x = a
        for gi, (_span, mat, d_in, d_out) in enumerate(groups):
            if mat is None:
                continue
            A, B = prod(dims[:gi]), prod(dims[gi + 1:])
            if self.mac_log is not None:
                self.mac_log.append((L, d_in, d_out, A * B))
            x = _matmul_mod(self._mat_halves(mat, qs), x.reshape(L, A, d_in, B), qs)
            dims[gi] = d_out
        return x.reshape(L, -1)

    # -- signed helpers (host round trips, as in xla.py:430-441) -------------

    def lift_centered(self, a, qs):
        """Residues → centered signed representatives in (-q/2, q/2], as a
        host int64 array."""
        arr = self.to_numpy(a)
        q = np.asarray(qs, dtype=np.int64)[:, None]
        return np.where(arr > q // 2, arr - q, arr)

    def reduce_signed(self, a_signed, qs):
        return self.asarray(np.asarray(a_signed, dtype=np.int64), qs)

    def broadcast_row(self, row, nlimb, qs):
        r = np.asarray(row, dtype=np.int64)
        return self.asarray(np.broadcast_to(r[None, :], (nlimb, r.shape[0])), qs)

    # -- composite device ops (bit-identical to backend/golden.py) ----------

    def stack_rows(self, rows):
        return torch.stack(list(rows))

    def rescale_step(self, data, qs, zp):
        """Drop the last limb q_k: (data − δ)/q_k with δ ≡ data (mod q_k),
        δ ≡ 0 (mod zp), δ small (golden.py `rescale_step`)."""
        return modq.rescale_step(data, qs, zp)

    def modswitch_up(self, data, old_qs, new_qs):
        """Exact scaling to a longer prefix: old limbs ×(∏ new extra limbs),
        new limbs ≡ 0."""
        old_qs, new_qs = tuple(old_qs), tuple(new_qs)
        d = prod(new_qs[len(old_qs):])
        return modq.scale_pad(data, (d,) * len(old_qs), old_qs, len(new_qs))

    def hybrid_digit_rows(self, data, qs, groups, ext_qs):
        """[dnum, T, n] hybrid digit rows: for each limb group, the exact
        Garner lift V_j < Q_j reduced modulo every limb of ext_qs
        (golden.py `hybrid_digit_rows`, through `modarith.garner_digits`
        and `extend_digits`)."""
        ext_qs = tuple(ext_qs)
        out = []
        off = 0
        for grp in groups:
            grp = tuple(grp)
            xs = garner_digits(data[off:off + len(grp)], grp)
            out.append(extend_digits(xs, grp, ext_qs))
            off += len(grp)
        return torch.stack(out)

    def gadget_digit_rows(self, data, qs, base):
        """[D, L, n] digit rows of POW-basis residues. base=None → CRT/Triv
        digits (row i = limb-i residues reduced into every limb); base=b →
        per-limb base-b digits, limb-major."""
        q = qcol(tuple(qs), self.device)[None]       # [1, L, 1]
        if base is None:
            return data[:, None, :] % q
        out = []
        for i, qi in enumerate(qs):
            nd = 0
            v = qi - 1
            while v:
                nd += 1
                v //= base
            powers = qcol(tuple(base**k for k in range(nd)), data.device)
            digits = data[i][None, :] // powers % base   # [nd, n]
            out.append(digits[:, None, :] % q)
        return torch.cat(out)
