"""Moduli and RNS chains.

A `Modulus` is a single NTT-friendly prime q < 2^31 together with its noise-unit
capacity (the reification of the reference's `TLNatNat`/`mkModulus`,
Noise.hs:96-105, 166-170). An `RnsChain` is the ordered list of pairwise-coprime
moduli from which PT2CT selects prefixes (`Zqs` in the examples,
e.g. examples/Arithmetic.hs:31-34).

Levels are identified by *prefix length*: a ciphertext "at k limbs" is defined
modulo q_1·...·q_k. PT2CT's modulus assignment picks the shortest prefix with
enough noise units (Noise.hs:129-151).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from alchemy_tpu_torch.nt.primes import units_of_modulus


@dataclass(frozen=True)
class Modulus:
    """A single RNS limb prime."""

    q: int

    def __post_init__(self):
        if not (2 < self.q < (1 << 31)):
            raise ValueError(f"modulus must be in (2, 2^31): {self.q}")

    @property
    def units(self) -> int:
        """Noise units ⌊log2 q / 6.1⌋ (Noise.hs:166-170)."""
        return units_of_modulus(self.q)

    def __repr__(self):
        return f"Zq({self.q})"


class RnsChain:
    """An ordered list of distinct NTT-friendly primes (the `zqs` type list)."""

    def __init__(self, qs: list[int] | tuple[int, ...]):
        qs = tuple(int(q) for q in qs)
        if len(set(qs)) != len(qs):
            raise ValueError("RNS moduli must be distinct")
        self.moduli = tuple(Modulus(q) for q in qs)

    @property
    def qs(self) -> tuple[int, ...]:
        return tuple(m.q for m in self.moduli)

    def __len__(self):
        return len(self.moduli)

    def __iter__(self):
        return iter(self.moduli)

    def __getitem__(self, i):
        return self.moduli[i]

    @property
    def unit_list(self) -> tuple[int, ...]:
        return tuple(m.units for m in self.moduli)

    def total_units(self, nlimb: int | None = None) -> int:
        us = self.unit_list
        if nlimb is not None:
            us = us[:nlimb]
        return sum(us)

    def prefix_len_for_units(self, h: int) -> int:
        """Length of the shortest nonempty prefix with >= h total units
        (Noise.hs:107-121 `prefixLen`), with the reference's error semantics
        (Noise.hs:142-151) when the whole chain is insufficient."""
        total = self.total_units()
        if h > total:
            raise ValueError(
                f"ZqsWithUnits: Modulus needs to support at least {h} noise "
                f"units, but it only supports {total} units. "
                f"You need more/bigger moduli!"
            )
        acc = 0
        for i, m in enumerate(self.moduli):
            acc += m.units
            if acc >= h:
                return i + 1
        raise AssertionError("unreachable")

    def product(self, nlimb: int) -> int:
        p = 1
        for m in self.moduli[:nlimb]:
            p *= m.q
        return p

    def __repr__(self):
        return f"RnsChain{self.qs}"


@lru_cache(maxsize=None)
def _inv_mod(a: int, q: int) -> int:
    return pow(a % q, -1, q)
