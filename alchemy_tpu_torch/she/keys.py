"""Seeded host sampling (`alchemy_tpu/she/keys.py:24-30`).

The same numpy `Generator` calls as the JAX package, so one seed gives the
same keys and errors in both packages. `SK` comes with the general
cyclotomic layer.
"""

from __future__ import annotations

import math

import numpy as np


def gaussian_coeffs(rng: np.random.Generator, variance: float, n: int) -> np.ndarray:
    """Rounded continuous Gaussian with the given variance, as int64."""
    return np.rint(rng.normal(0.0, math.sqrt(variance), size=n)).astype(np.int64)


def uniform_residues(rng: np.random.Generator, qs: tuple[int, ...], n: int) -> np.ndarray:
    """Uniform residues [L, n] (int64), one row per modulus."""
    return np.stack([rng.integers(0, q, size=n, dtype=np.int64) for q in qs])
