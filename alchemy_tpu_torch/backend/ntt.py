"""Exact radix-2 negacyclic NTT in plain torch (port of
`alchemy_tpu/backend/ntt.py`, the slot order of `FastParams(impl="vpu")`).

Forward: the ψ^j pre-twist, then a radix-2 DIF cyclic NTT with ω = ψ²
(natural order in, bit-reversed out), so slot s holds x(ψ^{2K+1}) with
K = bitrev(s) and ψ = root_of_unity(2n, q). Inverse: the DIT mirror
(bit-reversed in, natural out) with ψ^{-j}·n⁻¹ folded into the post-twist.
The stages and tables are those of `ntt_negacyclic` / `intt_negacyclic`
(ntt.py:149, :173); the JAX package's Shoup products on uint32 lanes become
int64 products below 2^62 reduced with `%`.

Values are uint32 held in int64 tensors (see modarith); both transforms
reduce their input mod q first, so they take any uint32 and return
canonical residues, as the kernels in this order do. On canonical input they
return the JAX functions' residues. These transforms are the plain versions
of the standalone kernels in this order and of the vpu order of kernels A,
B, 4 and 7.

`cyclic_ntt_stages` / `cyclic_intt_stages` (ntt.py:102, :125) are the bare
radix-2 cyclic stages over the last axis with caller-given per-limb tables,
the local stages of the distributed 4-step NTT (`parallel/dist.py`).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from alchemy_tpu_torch.backend.modarith import _add_mod, _sub_mod
from alchemy_tpu_torch.backend.ntt3 import psi_powers


@lru_cache(maxsize=None)
def ntt_tables(n: int, qs: tuple[int, ...]) -> dict:
    """int64 numpy tables (ntt.py:26): `pre` ψ^j and `post` ψ^{-j}·n⁻¹,
    [L, n]; per stage s (m = n >> (s + 1)) `fwd[s]` ω^{j·2^s} and `inv[s]`
    their inverses, [L, m]."""
    if n & (n - 1):
        raise ValueError(f"ring size {n} is not a power of two")
    two_n, k = 2 * n, n.bit_length() - 1
    j = np.arange(n, dtype=np.int64)
    pre, post = [], []
    fwd = [[] for _ in range(k)]
    inv = [[] for _ in range(k)]
    for q in qs:
        p = psi_powers(n, q)
        pre.append(p[j])
        post.append(p[(two_n - j) % two_n] * pow(n, -1, q) % q)
        for s in range(k):
            e = (2 << s) * j[:n >> (s + 1)] % two_n
            fwd[s].append(p[e])
            inv[s].append(p[(two_n - e) % two_n])
    return {"pre": np.stack(pre), "post": np.stack(post),
            "fwd": [np.stack(t) for t in fwd], "inv": [np.stack(t) for t in inv]}


@lru_cache(maxsize=None)
def _device_tables(n: int, qs: tuple[int, ...], device: str) -> dict:
    t = ntt_tables(n, qs)
    dev = lambda a: torch.from_numpy(a).to(device)
    return {"q": torch.tensor(qs, dtype=torch.int64, device=device)[:, None],
            "pre": dev(t["pre"]), "post": dev(t["post"]),
            "fwd": [dev(a)[:, None, :] for a in t["fwd"]],
            "inv": [dev(a)[:, None, :] for a in t["inv"]]}


def _tables(n, qs, device) -> dict:
    return _device_tables(n, tuple(qs), str(torch.device(device)))


def ntt_vpu(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward negacyclic NTT on [..., L, n]: natural order in (any uint32),
    bit-reversed (vpu) slot order out, canonical (`ntt_negacyclic`)."""
    t = _tables(n, qs, x.device)
    q = t["q"]
    q3 = q[:, :, None]
    lead, L = x.shape[:-2], x.shape[-2]
    x = x % q * t["pre"] % q
    for s in range(n.bit_length() - 1):
        xs = x.reshape(*lead, L, 1 << s, 2, n >> (s + 1))
        a, b = xs[..., 0, :], xs[..., 1, :]
        bot = (a - b) % q3 * t["fwd"][s] % q3
        x = torch.stack([(a + b) % q3, bot], dim=-2).reshape(*lead, L, n)
    return x


def intt_vpu(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Inverse of `ntt_vpu` (`intt_negacyclic`): vpu slot order in (any
    uint32), natural order out, canonical."""
    t = _tables(n, qs, x.device)
    q = t["q"]
    q3 = q[:, :, None]
    lead, L = x.shape[:-2], x.shape[-2]
    x = x % q
    for s in reversed(range(n.bit_length() - 1)):
        xs = x.reshape(*lead, L, 1 << s, 2, n >> (s + 1))
        a, bw = xs[..., 0, :], xs[..., 1, :] * t["inv"][s] % q3
        x = torch.stack([(a + bw) % q3, (a - bw) % q3], dim=-2).reshape(*lead, L, n)
    return x * t["post"] % q


def ntt_vpu_bcast(x: torch.Tensor, n: int, qs: tuple[int, ...]) -> torch.Tensor:
    """Forward NTT of each row of x [..., D, n] under every limb → [..., D,
    L, n]; rows may be unreduced uint32 (the digit path of fast.py:369-374,
    which reduces the broadcast rows mod each limb, then transforms)."""
    return ntt_vpu(x.unsqueeze(-2).expand(*x.shape[:-1], len(qs), n), n, qs)


def cyclic_ntt_stages(x: torch.Tensor, stages, q: torch.Tensor) -> torch.Tensor:
    """Radix-2 DIF cyclic NTT over the last axis of int64 x [..., L, size]
    (natural order in, bit-reversed out), `cyclic_ntt_stages` of ntt.py:102:
    `stages[s]` is the (W, WS) pair of twiddles [L, size >> (s + 1)] with
    their Shoup companions and q is [L, 1]. Each Shoup product is computed
    as the exact int64 product mod q, which it equals for every uint32
    input; sums and differences wrap at 32 bits as the uint32 lanes do, so
    every uint32 input gives the JAX function's output."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    q3 = q[..., None, :]
    for s in range(n.bit_length() - 1):
        xs = x.reshape(*lead, 1 << s, 2, n >> (s + 1))
        a, b = xs[..., 0, :], xs[..., 1, :]
        bot = _sub_mod(a, b, q3) * stages[s][0][..., None, :] % q3
        x = torch.stack([_add_mod(a, b, q3), bot], dim=-2).reshape(*lead, n)
    return x


def cyclic_intt_stages(x: torch.Tensor, inv_stages, q: torch.Tensor, n_inv=None) -> torch.Tensor:
    """Inverse of `cyclic_ntt_stages` (bit-reversed in, natural out),
    `cyclic_intt_stages` of ntt.py:125; with n_inv, a (w, ws) pair [L, 1],
    it folds in the scale by 1/n."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    q3 = q[..., None, :]
    for s in reversed(range(n.bit_length() - 1)):
        xs = x.reshape(*lead, 1 << s, 2, n >> (s + 1))
        a, bw = xs[..., 0, :], xs[..., 1, :] * inv_stages[s][0][..., None, :] % q3
        x = torch.stack([_add_mod(a, bw, q3), _sub_mod(a, bw, q3)], dim=-2).reshape(*lead, n)
    if n_inv is not None:
        x = x * n_inv[0] % q
    return x
