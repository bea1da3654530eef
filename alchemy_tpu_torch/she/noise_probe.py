"""Device-resident noise probe (`alchemy_tpu/she/noise_probe.py`).

The reference's ERW computes `errorRate = max|errorTermUnrestricted sk ct|/q`
per op (reference Crypto/Alchemy/Interpreter/ErrorRateWriter.hs:85-106,
Eval.hs:150-160). The host probe (she/bgv.error_rate) does an exact
per-coefficient CRT lift in Python ints: O(n) host work and one copy of the
whole error term per probe.

This module computes the SAME quantity with all O(n·L) work on the
tensor's device, exactly (no float approximation), in the Garner
mixed-radix digit domain (`backend/modarith.garner_digits`, integer-only
int64 tensor code):

  1. digits x_k of every coefficient's lift V ∈ [0, Q), V = Σ x_k·π_k;
  2. centering: V > Q/2 detected by msd-first digit comparison with the
     digits of Q//2;
  3. |V_c| for the negative half by exact mixed-radix negation Q − V
     (complement digits + ripple carry, L steps);
  4. the maximum over coefficients by an msd-first tournament (L masked
     max-reductions: lexicographic order in mixed radix IS numeric order).

Only the [L] digit vector of max_i |e_i| leaves the device; the final
rate = |e|/Q is an O(L) exact big-int division on the host. Every digit is
below 2^31, so int64 holds every intermediate, and int64 comparisons run on
the CPU too.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from alchemy_tpu_torch.backend.modarith import _garner_tables, garner_digits


def max_abs_digits(res: torch.Tensor, qs: tuple[int, ...]) -> torch.Tensor:
    """int64 residues [L, n] (pow basis) → [L] int64 mixed-radix digits (lsd
    first, bases `qs`) of max_i |centered CRT lift of column i|."""
    L = len(qs)
    xs = garner_digits(res.to(torch.int64), qs)      # L × [n]

    Q = 1
    for q in qs:
        Q *= q
    hd = []
    h = Q // 2
    for g in qs:
        hd.append(h % g)
        h //= g

    # V > Q//2 ⇔ negative half (centered lift V - Q)
    gt = torch.zeros_like(xs[0], dtype=torch.bool)
    eq = torch.ones_like(xs[0], dtype=torch.bool)
    for k in range(L - 1, -1, -1):
        gt = gt | (eq & (xs[k] > hd[k]))
        eq = eq & (xs[k] == hd[k])
    is_neg = gt

    # |V_c| for the negative half: Q - V = complement digits + 1 (ripple
    # carry over the L digit positions; V > Q/2 > 0 so no wrap)
    carry = torch.ones_like(xs[0])
    neg = []
    for k in range(L):
        t = (qs[k] - 1 - xs[k]) + carry
        wrap = t == qs[k]
        neg.append(torch.where(wrap, torch.zeros_like(t), t))
        carry = wrap.to(torch.int64)
    digs = [torch.where(is_neg, neg[k], xs[k]) for k in range(L)]

    # exact max over coefficients: msd-first masked tournament
    mask = torch.ones_like(xs[0], dtype=torch.bool)
    out = [None] * L
    for k in range(L - 1, -1, -1):
        m = torch.where(mask, digs[k], torch.zeros_like(digs[k])).max()
        mask = mask & (digs[k] == m)
        out[k] = m
    return torch.stack(out)


def rate_from_digits(digits, qs: tuple[int, ...]) -> float:
    """Exact host conversion of an [L] digit sequence (host ints) to
    max|e|/Q: an O(L) big-int evaluation, the only host arithmetic of the
    device probe."""
    pi, _ = _garner_tables(tuple(qs))
    V = 0
    for k in range(len(qs)):
        V += int(digits[k]) * pi[k]
    Q = 1
    for q in qs:
        Q *= q
    return float(V / Q)


@dataclass
class DeferredRate:
    """A probe result whose digits are still a device tensor;
    interp/error_writer.resolve_log reads every deferred one back in one
    copy and converts it to a float."""

    digits: torch.Tensor
    qs: tuple[int, ...]

    def resolve(self) -> float:
        return rate_from_digits(self.digits.tolist(), self.qs)


def _error_acc(sk, ct):
    """Σ c_k s^k over the ct chain, pow basis, on the ct's backend."""
    s = sk.as_cyc(ct.qs, ct.bk)
    acc = ct.comps[0]
    spow = None
    for k in range(1, len(ct.comps)):
        spow = s if spow is None else spow * s
        acc = acc + ct.comps[k] * spow
    return acc.to_pow()


def error_digits(sk, ct) -> torch.Tensor:
    """[L] max-|error| digit vector of a ciphertext on a `TorchBackend`,
    computed on the ciphertext's device."""
    acc = _error_acc(sk, ct)
    return max_abs_digits(acc.data, acc.qs)


def error_rate_device(sk, ct) -> float:
    """she/bgv.error_rate (max|e_i|/Q, Eval.hs:158-160) with the O(n) work
    on the device; parity with the host probe is pinned by
    tests/test_torch_interp.py."""
    return DeferredRate(error_digits(sk, ct), ct.qs).resolve()
