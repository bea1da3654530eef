"""E-linear maps between cyclotomic rings (Lol's `Linear t zp e r s`).

A `LinearMap` is specified by the images y_j ∈ R_s of the relative basis
elements d_j of R_r over R_e. The default basis is the relative DECODING
basis — Lol's `linearDec` (Common.hs:65-75; LPR toolkit §6: the difference
basis d_j = ζ^j − ζ^{j−1} on odd primes absent from e, pure powers
elsewhere — core/cyc.py). basis="pow" selects the relative powerful basis.

Evaluation (Lol `evalLin`, Eval.hs:141): f(x) = Σ_j embed_{e→s}(x_j)·y_j
where x = Σ_j d_j·x_j with x_j ∈ R_e.
"""

from __future__ import annotations

from dataclasses import dataclass

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.nt.factor import fgcd, totient


@dataclass
class LinearMap:
    e: int
    r: int
    s: int
    images: tuple[Cyc, ...]  # y_j ∈ R_s (over the plaintext modulus)
    basis: str = "dec"       # relative basis the images refer to

    def __post_init__(self):
        assert self.r % self.e == 0 and self.s % self.e == 0
        dim = totient(self.r) // totient(self.e)
        assert len(self.images) == dim, (len(self.images), dim)

    @property
    def dim(self) -> int:
        return len(self.images)

    def eval(self, x: Cyc) -> Cyc:
        """Plaintext evaluation (the E interpreter's linearCyc_)."""
        assert x.m == self.r
        coeffs = x.rel_coeffs(self.e, basis=self.basis)
        acc = None
        for xj, yj in zip(coeffs, self.images):
            term = xj.embed(self.s) * yj
            acc = term if acc is None else acc + term
        return acc
