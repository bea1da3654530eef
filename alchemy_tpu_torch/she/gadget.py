"""Gadget vectors and digit decomposition over an RNS modulus.

The gadget for a multi-limb modulus Q = ∏ q_i is the CRT gadget tensored with
a per-limb gadget (this is how Lol's pair-type gadget instances compose;
reference usage PT2CT.hs:136-140):

- `TrivGad`: per-limb part is trivial — digit i is the lift of the residue
  [c]_{q_i} (magnitude < q_i ≈ 2^30.5, matching the reference's
  Max32BitUnits hint-noise constant, PT2CT.hs:283-285).
- `BaseBGad(2)`: per-limb binary decomposition — digits are bits, so hint
  noise does not pay the digit-magnitude penalty (PT2CT.hs:140).

Digits of a ring element are *single-limb residues* (or their bits), so
re-reducing them modulo every hint limb is exact — no CRT lifting anywhere
(DESIGN.md, RNS discipline).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc


def _crt_gadget_factors(qs: tuple[int, ...]) -> list[int]:
    """g_i = (Q/q_i)·[(Q/q_i)^{-1}]_{q_i} mod Q, as exact ints."""
    Q = 1
    for q in qs:
        Q *= q
    out = []
    for q in qs:
        Qi = Q // q
        out.append(Qi * pow(Qi % q, -1, q) % Q)
    return out


@dataclass(frozen=True)
class Gadget:
    """Base class; instances are stateless and hashable (used as cache keys)."""

    def num_digits(self, qs: tuple[int, ...]) -> int:
        raise NotImplementedError

    def factors(self, qs: tuple[int, ...]) -> list[int]:
        """Gadget vector entries g_k as ints mod Q."""
        raise NotImplementedError

    def digits(self, c: Cyc) -> list[Cyc]:
        """Decompose a ring element over its own modulus chain: returns
        num_digits ring elements over the same chain with Σ g_k·d_k = c."""
        raise NotImplementedError

    def digit_noise_bits(self, qs: tuple[int, ...]) -> float:
        """log2 of the max digit magnitude (for the noise ledger)."""
        raise NotImplementedError


@dataclass(frozen=True)
class TrivGad(Gadget):
    def num_digits(self, qs):
        return len(qs)

    def factors(self, qs):
        return _crt_gadget_factors(qs)

    def digits(self, c):
        arr = c.to_pow()
        rows = arr.bk.gadget_digit_rows(arr.data, arr.qs, None)
        return [Cyc(arr.ring, arr.qs, "POW", rows[i], arr.bk) for i in range(len(c.qs))]

    def digit_noise_bits(self, qs):
        import math

        return max(math.log2(q) for q in qs)

    def __repr__(self):
        return "TrivGad"


@dataclass(frozen=True)
class HybridGad(Gadget):
    """Hybrid key-switching gadget: the chain is grouped into dnum digits of
    α = ⌈L/dnum⌉ limbs and the switch runs over the extended modulus Q·P
    with a special modulus P = ∏ ps ≥ max Q_j (she/hybrid.py is the raw fast
    path of the same technique; this class plugs it into the PT2CT compiler's
    per-gadget KSPNoise slot, reference PT2CT.hs:136-140). Digit magnitude
    cancels against P in the switch noise, so the ledger charges it like
    BaseBGad (no TrivGad digit penalty — interp/noise.py ks_pnoise).

    `dnum=None` picks ⌈L/4⌉ per chain (she/hybrid.pick_dnum); `sp_bits=None`
    sizes the special primes at the chain's own width, widening until
    P ≥ max Q_j (the hybrid noise condition)."""

    dnum: int | None = None
    sp_bits: int | None = None

    def groups_of(self, qs: tuple[int, ...]) -> tuple[tuple[int, ...], ...]:
        from alchemy_tpu_torch.she.hybrid import pick_dnum

        L = len(qs)
        dnum = pick_dnum(L) if self.dnum is None else self.dnum
        alpha = -(-L // dnum)
        return tuple(tuple(qs[i:i + alpha]) for i in range(0, L, alpha))

    def special_primes(self, qs: tuple[int, ...], m_prime: int) -> tuple[int, ...]:
        """Deterministic special-modulus limbs ≡ 1 mod m' with P ≥ max Q_j."""
        from alchemy_tpu_torch.nt.primes import find_ntt_prime

        groups = self.groups_of(qs)
        k_sp = max(len(g) for g in groups)
        bits = self.sp_bits
        if bits is None:
            bits = max(q.bit_length() for q in qs)
        max_Qj = max(int(np.prod([1] + [int(g) for g in grp], dtype=object))
                     for grp in groups)
        while True:
            ps: list[int] = []
            while len(ps) < k_sp:
                ps.append(find_ntt_prime(m_prime, bits,
                                         avoid=tuple(qs) + tuple(ps)))
            P = 1
            for g in ps:
                P *= g
            if P >= max_Qj or bits >= 31:
                return tuple(ps)
            bits += 1

    def num_digits(self, qs):
        return len(self.groups_of(qs))

    def factors(self, qs):
        """ĝ_j = (Q/Q_j)·[(Q/Q_j)^{-1}]_{Q_j} mod Q (the P scaling and the
        extension to Q·P live in the hint generation, she/bgv.py)."""
        Q = 1
        for q in qs:
            Q *= q
        out = []
        for grp in self.groups_of(qs):
            Qj = 1
            for g in grp:
                Qj *= g
            Qi = Q // Qj
            out.append(Qi * pow(Qi % Qj, -1, Qj) % Q)
        return out

    def digits(self, c):
        """Group-Garner digit rows over the element's OWN chain (the
        extension to Q·P happens in key_switch_quad via hybrid_digit_rows)."""
        arr = c.to_pow()
        rows = arr.bk.hybrid_digit_rows(
            arr.data, arr.qs, self.groups_of(arr.qs), arr.qs)
        return [Cyc(arr.ring, arr.qs, "POW", rows[i], arr.bk)
                for i in range(rows.shape[0])]

    def digit_noise_bits(self, qs):
        import math

        # the effective digit contribution after the P-division is ≈ 1
        # (|D_j|/P ≤ 1 when P ≥ max Q_j); charged like a unit-magnitude digit
        return math.log2(2)

    def __repr__(self):
        d = "" if self.dnum is None else f"dnum={self.dnum}"
        return f"HybridGad({d})"


@dataclass(frozen=True)
class BaseBGad(Gadget):
    base: int = 2

    def _limb_digits(self, q: int) -> int:
        n = 0
        v = q - 1
        while v:
            n += 1
            v //= self.base
        return n

    def num_digits(self, qs):
        return sum(self._limb_digits(q) for q in qs)

    def factors(self, qs):
        crt = _crt_gadget_factors(qs)
        Q = 1
        for q in qs:
            Q *= q
        out = []
        for i, q in enumerate(qs):
            for k in range(self._limb_digits(q)):
                out.append(crt[i] * pow(self.base, k, Q) % Q)
        return out

    def digits(self, c):
        arr = c.to_pow()
        rows = arr.bk.gadget_digit_rows(arr.data, arr.qs, self.base)
        return [
            Cyc(arr.ring, arr.qs, "POW", rows[i], arr.bk)
            for i in range(rows.shape[0])
        ]

    def digit_noise_bits(self, qs):
        import math

        return math.log2(self.base)

    def __repr__(self):
        return f"BaseBGad({self.base})"
