"""Secret keys and seeded sampling (`alchemy_tpu/she/keys.py`).

`SK` mirrors Lol's `SK v (Cyc t m' z)` (SURVEY.md §2.3): integer coefficients
(powerful basis) sampled as a rounded Gaussian whose variance is the scaled
parameter v = r/√φ(m') supplied by the KeysHints context (KeysHints.hs:85-96).
The key stores v so encryption/hint errors reuse it (as Lol's encrypt does).

All sampling is host-side numpy from named seeds, with the same numpy
`Generator` calls as the JAX package, so one seed gives the same keys and
errors in both packages and on every backend.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.core.ring import get_ring


def gaussian_coeffs(rng: np.random.Generator, variance: float, n: int) -> np.ndarray:
    """Rounded continuous Gaussian with the given variance, as int64."""
    return np.rint(rng.normal(0.0, math.sqrt(variance), size=n)).astype(np.int64)


def uniform_residues(rng: np.random.Generator, qs: tuple[int, ...], n: int) -> np.ndarray:
    """Uniform residues [L, n] (int64), one row per modulus."""
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in qs])


@dataclass
class SK:
    """Secret key: small integer element of R_{m'}."""

    m: int
    variance: float
    coeffs: np.ndarray  # int64 [phi(m')], signed, powerful basis
    _cache: dict = field(default_factory=dict, repr=False)

    @staticmethod
    def generate(m: int, variance: float, rng: np.random.Generator) -> "SK":
        ring = get_ring(m)
        return SK(m, variance, gaussian_coeffs(rng, variance, ring.phi))

    def as_cyc(self, qs: tuple[int, ...], bk) -> Cyc:
        # keyed on the backend object: two torch backends share a name but
        # may hold their tensors on different devices
        key = (qs, bk)
        if key not in self._cache:
            self._cache[key] = Cyc.from_coeffs(self.m, qs,
                np.stack([self.coeffs % q for q in qs]), bk)
        return self._cache[key]

    def error(self, qs: tuple[int, ...], rng: np.random.Generator, bk) -> tuple[Cyc, np.ndarray]:
        """Sample a fresh error with this key's variance; returns (Cyc, int coeffs)."""
        ring = get_ring(self.m)
        e = gaussian_coeffs(rng, self.variance, ring.phi)
        return Cyc.from_coeffs(self.m, qs, np.stack([e % q for q in qs]), bk), e
