"""The general path's mod-q kernels (`csrc/modq.cu`): wrappers and plain
versions of `TorchBackend`'s arithmetic on int64 residues.

Each wrapper is one launch in place of a chain of torch ops: `split16` and
`recombine` around each float64 GEMM of `torch_backend._matmul_mod` (its
operand's 16-bit halves, then the four partial sums reduced and recombined
mod q), `binop` for `add`, `sub`, `neg` and `mul`, `scale_pad` for
`mul_const` and `modswitch_up`, `rescale_step`. `sum_terms`, which no path
of the program calls, folds `binop("add")` on the card. They replace no Pallas
kernel: the JAX package's `XlaBackend` (`alchemy_tpu/backend/xla.py`)
leaves this arithmetic to XLA's fused elementwise ops. `csrc/modq.cu` says
what bounds them.

The kernels take canonical residues in [0, q), q < 2^31, as every method of
`TorchBackend` hands them on (its docstring), and return canonical
residues, bit-identical to the plain versions: today's torch ops, which take
CPU tensors. On the card a wrapper checks each operand's dtype, shape and
device, but not that its residues are canonical: a value outside [0, q)
gives a wrong residue there, where the plain version reduces it. Operands
are read in place through their strides; outputs are new contiguous
tensors. The per-limb constants, rows of zq.cuh `Limb` words
(`launch.limb_words`), go to the card once per moduli (`launch.uploaded`),
so a captured CUDA graph copies nothing from the host. Each wrapper follows
the launch protocol of `launch.py`.
"""

from __future__ import annotations

import numpy as np
import torch

from alchemy_tpu_torch.backend.cuda import launch
from alchemy_tpu_torch.backend.modarith import qcol

#: the element-wise operations of `binop` and their codes in `csrc/modq.cu`
OPS = {"add": 0, "sub": 1, "neg": 2, "mul": 3}
#: elements of one launch: the kernels index in 32 bits
MAX_ELEMS = 1 << 30
#: zp of `rescale_step`: every int64 product of the plain version is exact below
ZP_LIMIT = 1 << 33


# ---------------------------------------------------------------------------
# constant tables ([L, 8] uint32: zq.cuh `Limb` rows, `launch.limb_words`)
# ---------------------------------------------------------------------------


def _table(qs, ws=None, w2s=None) -> np.ndarray:
    """The `Limb` rows of qs with constants ws (words 1, 2) and w2s (6, 7)."""
    for q in qs:
        if not 1 < q < 1 << 31:
            raise ValueError(f"modulus {q}: the mod-q kernels take 1 < q < 2^31")
    ws, w2s = ws or (0,) * len(qs), w2s or (0,) * len(qs)
    return np.array([launch.limb_words(q, w, w2) for q, w, w2 in zip(qs, ws, w2s)],
                    dtype=np.uint32).reshape(len(qs), 8)


def modq_limbs(qs: tuple[int, ...]) -> np.ndarray:
    """`gp_recombine` and `gp_binop`: w = 2^16 mod q, w2 = 2^32 mod q."""
    return _table(qs, tuple((1 << 16) % q for q in qs), tuple((1 << 32) % q for q in qs))


def scale_table(ws: tuple[int, ...], qs: tuple[int, ...]) -> np.ndarray:
    """`gp_scale_pad`: w < q the scale of each limb."""
    return _table(qs, ws)


def rescale_step_consts(qs: tuple[int, ...]) -> np.ndarray:
    """`gp_rescale_step`, for the kept limbs qs[:-1] of a rescale that drops
    q_k = qs[-1]: w = q_k⁻¹ mod q."""
    return _table(qs[:-1], tuple(pow(qs[-1], -1, q) for q in qs[:-1]))


def _limbs(qs, dev) -> torch.Tensor:
    return launch.uploaded(modq_limbs, tuple(qs), device=str(dev))


# ---------------------------------------------------------------------------
# plain versions (exact int64 torch ops)
# ---------------------------------------------------------------------------


def split16_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain `gp_split16`: x [L, A, K, B] → [L, K, 2R] float64, R = A·B."""
    L, A, K, B = x.shape
    x = x.movedim(2, 1).reshape(L, K, A * B)
    return torch.cat((x & 0xFFFF, x >> 16), dim=2).to(torch.float64)


def recombine_plain(p: torch.Tensor, qs: tuple[int, ...], A: int, B: int) -> torch.Tensor:
    """Plain `gp_recombine`: p [L, 2D, 2R] float64 → [L, A, D, B] int64."""
    L, D, R = p.shape[0], p.shape[1] // 2, p.shape[2] // 2
    q = qcol(qs, p.device)[:, :, None]                                # [L, 1, 1]
    p = p.to(torch.int64) % q
    lo, lh = p[:, :D, :R], p[:, :D, R:]
    hl, hh = p[:, D:, :R], p[:, D:, R:]
    r16 = qcol(tuple((1 << 16) % v for v in qs), p.device)[:, :, None]
    r32 = qcol(tuple((1 << 32) % v for v in qs), p.device)[:, :, None]
    out = (lo + (lh + hl) % q * r16 % q + hh * r32 % q) % q
    return out.reshape(L, D, A, B).movedim(1, 2)


def binop_plain(op: str, a: torch.Tensor, b: torch.Tensor | None,
                qs: tuple[int, ...]) -> torch.Tensor:
    q = qcol(qs, a.device)
    if op == "add":
        return (a + b) % q
    if op == "sub":
        return (a - b) % q
    if op == "neg":
        return (-a) % q
    return a * b % q


def sum_plain(terms, qs: tuple[int, ...]) -> torch.Tensor:
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc % qcol(qs, acc.device)


def scale_pad_plain(x: torch.Tensor, ws: tuple[int, ...], qs: tuple[int, ...],
                    rows: int) -> torch.Tensor:
    """Plain `gp_scale_pad`: the first len(qs) rows of x times ws mod qs,
    then zero rows up to `rows`."""
    scaled = x[:len(qs)] * qcol(ws, x.device) % qcol(qs, x.device)
    if rows == len(qs):
        return scaled
    return torch.cat((scaled, x.new_zeros((rows - len(qs), x.shape[1]))))


def rescale_step_plain(data: torch.Tensor, qs: tuple[int, ...], zp: int) -> torch.Tensor:
    """Plain `gp_rescale_step` (golden.py `rescale_step`)."""
    qk = qs[-1]
    new_qs = qs[:-1]
    r = data[-1]
    r = torch.where(r > qk // 2, r - qk, r)
    t = (-r) * pow(qk, -1, zp) % zp
    t = torch.where(t > zp // 2, t - zp, t)
    delta = r + qk * t
    q = qcol(new_qs, data.device)
    inv_qk = qcol(tuple(pow(qk, -1, v) for v in new_qs), data.device)
    return (data[:-1] - delta) % q * inv_qk % q


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _residues(name: str, t: torch.Tensor, L: int, dev: torch.device,
              at_least: bool = False) -> None:
    """Raise unless t is an int64 [L, n] tensor ([≥ L, n] with `at_least`)
    on `dev`, small enough for one launch."""
    if (t.dtype != torch.int64 or t.dim() != 2 or t.numel() > MAX_ELEMS or t.device != dev
            or (t.shape[0] < L if at_least else t.shape[0] != L)):
        raise ValueError(f"{name}: want int64 rows [{'≥ ' * at_least}{L}, n] on {dev} of at "
                         f"most {MAX_ELEMS} words, got {t.dtype} {tuple(t.shape)} on {t.device}")


def split16(x: torch.Tensor) -> torch.Tensor:
    """`gp_split16`: x [L, A, K, B] int64 canonical, any strides (a view is
    read in place) → [L, K, 2R] float64, R = A·B, column r = a·B + b: the
    low 16 bits of x[l, a, k, b] at r, the high ones at R + r."""
    with launch.span("gp_split16"):
        L, A, K, B = x.shape
        if x.dtype != torch.int64 or x.numel() > MAX_ELEMS:
            raise ValueError(f"split16: want int64 of at most {MAX_ELEMS} words, got {x.dtype} "
                             f"{tuple(x.shape)}")
        dev = x.device
        if not launch.on_card(None, dev):
            return split16_plain(x)
        xs = torch.empty((L, K, 2 * A * B), dtype=torch.float64, device=dev)
        if xs.numel():
            launch.run("gp_split16", None, dev, (L, K, A * B), x.data_ptr(), xs.data_ptr(),
                       L, A, K, B, *x.stride())
        return xs


def recombine(p: torch.Tensor, qs: tuple[int, ...], A: int, B: int) -> torch.Tensor:
    """`gp_recombine`: p [L, 2D, 2R] float64 contiguous, R = A·B, the GEMM
    [W_lo; W_hi]·[x_lo | x_hi] of partial sums below 2^53 → [L, A, D, B]
    int64 in [0, q): lo + (lh + hl)·2^16 + hh·2^32 mod q, each partial sum
    reduced first."""
    with launch.span("gp_recombine"):
        qs = tuple(qs)
        L, D, R, dev = p.shape[0], p.shape[1] // 2, p.shape[2] // 2, p.device
        if (p.dtype != torch.float64 or p.shape != (len(qs), 2 * D, 2 * A * B)
                or not p.is_contiguous() or p.numel() > MAX_ELEMS):
            raise ValueError(f"recombine: want contiguous float64 [{len(qs)}, 2D, {2 * A * B}], "
                             f"got {p.dtype} {tuple(p.shape)}")
        if not launch.on_card(None, dev):
            return recombine_plain(p, qs, A, B)
        out = torch.empty((L, A, D, B), dtype=torch.int64, device=dev)
        if out.numel():
            launch.run("gp_recombine", None, dev, (L, D, R), p.data_ptr(), out.data_ptr(),
                       _limbs(qs, dev).data_ptr(), L, A, D, B, *out.stride())
        return out


def binop(op: str, a: torch.Tensor, b: torch.Tensor | None, qs) -> torch.Tensor:
    """`gp_binop`: a + b, a − b, −a (b None) or a·b mod q, row l mod qs[l]:
    a, b [L, n] int64 canonical (broadcast against each other), any strides
    → [L, n]."""
    with launch.span("gp_binop"):
        qs = tuple(qs)
        if op not in OPS:
            raise ValueError(f"binop: {op!r}, want one of {sorted(OPS)}")
        dev = a.device
        if not launch.on_card(None, dev):
            return binop_plain(op, a, b, qs)
        if b is not None:
            a, b = torch.broadcast_tensors(a, b)
        L = len(qs)
        _residues("binop", a, L, dev)
        b = a if b is None else b
        _residues("binop", b, L, dev)
        out = torch.empty(a.shape, dtype=torch.int64, device=dev)
        if out.numel():
            launch.run("gp_binop", None, dev, (op, L, a.shape[1]), a.data_ptr(), b.data_ptr(),
                       out.data_ptr(), _limbs(qs, dev).data_ptr(), OPS[op], L, a.shape[1],
                       *a.stride(), *b.stride())
        return out


def sum_terms(terms, qs) -> torch.Tensor:
    """Σ terms mod q, each term [L, n] int64 canonical: on the card one
    `binop("add")` a term after the first (a copy of a lone term), on the
    CPU the plain version."""
    qs, terms = tuple(qs), list(terms)
    if not launch.on_card(None, terms[0].device):
        return sum_plain(terms, qs)
    acc = terms[0]
    for t in terms[1:]:
        acc = binop("add", acc, t, qs)
    return acc.clone() if len(terms) == 1 else acc


def scale_pad(x: torch.Tensor, consts, qs, rows: int) -> torch.Tensor:
    """`gp_scale_pad`: the first L = len(qs) rows of x [≥ L, n] (int64
    canonical, any strides) times consts[l] mod qs[l], then zero rows up to
    `rows` ≥ L → [rows, n]."""
    with launch.span("gp_scale_pad"):
        qs = tuple(qs)
        ws = tuple(int(c) % q for c, q in zip(consts, qs))
        L, dev = len(qs), x.device
        if rows < L:
            raise ValueError(f"scale_pad: {rows} rows, fewer than the {L} scaled")
        if not launch.on_card(None, dev):
            return scale_pad_plain(x, ws, qs, rows)
        _residues("scale_pad", x, L, dev, at_least=True)
        out = torch.empty((rows, x.shape[1]), dtype=torch.int64, device=dev)
        if out.numel() > MAX_ELEMS:
            raise ValueError(f"scale_pad: {tuple(out.shape)} exceeds {MAX_ELEMS} words")
        if out.numel():
            table = launch.uploaded(scale_table, ws, qs, device=str(dev))
            launch.run("gp_scale_pad", None, dev, (L, rows, x.shape[1]), x.data_ptr(),
                       out.data_ptr(), table.data_ptr(), L, rows, x.shape[1], *x.stride())
        return out


def rescale_step(data: torch.Tensor, qs, zp: int) -> torch.Tensor:
    """`gp_rescale_step`: data [L + 1, n] over qs (int64 canonical, any
    strides) → [L, n] over qs[:-1]: (data − δ)·q_k⁻¹ with δ ≡ data[L] (mod
    q_k), δ ≡ 0 (mod zp), δ small (golden.py `rescale_step`); any zp with
    0 < zp < ZP_LIMIT prime to q_k."""
    with launch.span("gp_rescale_step"):
        qs = tuple(qs)
        qk, L, dev = qs[-1], len(qs) - 1, data.device
        if not 0 < zp < ZP_LIMIT:
            raise ValueError(f"rescale_step: zp={zp}, want 0 < zp < 2^33")
        if not launch.on_card(None, dev):
            return rescale_step_plain(data, qs, zp)
        _residues("rescale_step", data, L + 1, dev)
        out = torch.empty((L, data.shape[1]), dtype=torch.int64, device=dev)
        if out.numel():
            consts = launch.uploaded(rescale_step_consts, qs, device=str(dev))
            launch.run("gp_rescale_step", None, dev, (L, data.shape[1]), data.data_ptr(),
                       out.data_ptr(), consts.data_ptr(), L, data.shape[1], *data.stride(), qk,
                       zp, pow(qk, -1, zp))
        return out
