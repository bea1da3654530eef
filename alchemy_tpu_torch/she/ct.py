"""BGV ciphertexts.

`CT` mirrors Lol's `CT m zp (Cyc t m' zq)` (SURVEY.md §2.3): components are
elements of R_{m'} over the current RNS prefix; metadata records the
plaintext ring index m, plaintext modulus p, and the accumulated plaintext
scale factor (Lol tracks the same factor inside its CT; here it changes only
under modSwitch when a dropped/added limb is ≢ 1 mod p).

Decryption relation (LSB encoding): Σ_k c_k·s^k = scale·µ̃ + p·e (mod Q),
with µ̃ the centered-lifted embedding of the plaintext µ ∈ R_m,p into R_{m'}.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

from alchemy_tpu_torch.core.cyc import Cyc


@dataclass
class CT:
    m: int            # plaintext ring index
    zp: int           # plaintext modulus p (prime power)
    scale: int        # plaintext scale factor (unit mod zp)
    comps: tuple[Cyc, ...]  # over R_{m'}, same qs; len 2 (linear) or 3 (quadratic)

    @property
    def m_prime(self) -> int:
        return self.comps[0].m

    @property
    def qs(self) -> tuple[int, ...]:
        return self.comps[0].qs

    @property
    def bk(self):
        return self.comps[0].bk

    @property
    def degree(self) -> int:
        return len(self.comps) - 1

    def with_comps(self, comps, **kw) -> "CT":
        return replace(self, comps=tuple(comps), **kw)

    def __repr__(self):
        return (
            f"CT(m={self.m}, zp={self.zp}, m'={self.m_prime}, "
            f"nlimb={len(self.qs)}, deg={self.degree}, scale={self.scale})"
        )
