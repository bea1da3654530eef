"""The pNoise ledger: reification of the reference's type-level noise
machinery (Interpreter/PT2CT/Noise.hs and the PT2CT constants/type families,
PT2CT.hs:132-140, 232-296), with identical constants and rules.

A plaintext type is `PtTy(pnoise, m, zp)` (the reference's
`PNoiseCyc ('PN p) t m zp`); pnoise ≈ −log(noise rate) in units of 6.1 bits.

A copy of `alchemy_tpu/interp/noise.py`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from alchemy_tpu_torch.core.params import RnsChain
from alchemy_tpu_torch.she.gadget import BaseBGad, Gadget, HybridGad, TrivGad

#: bits per noise unit (Noise.hs:153-155)
PNOISE_UNIT = 6.1
#: pNoise lost in a key switch, gadget-independent: ⌈12/6.1⌉ (PT2CT.hs:280-281)
KS_ACCUM_PNOISE = math.ceil(12 / PNOISE_UNIT)
#: max units in a <32-bit modulus, the TrivGad digit penalty: ⌈30.5/6.1⌉ (:283-285)
MAX_32BIT_UNITS = math.ceil(30.5 / PNOISE_UNIT)
#: pNoise cost of a multiplication (~18 bits): ⌈18/6.1⌉ (:287-289)
MUL_PNOISE = math.ceil(18 / PNOISE_UNIT)
#: units needed to decrypt at zero pNoise (absolute noise ~2000): ⌈12/6.1⌉ (:291-293)
MIN_UNITS = math.ceil(12 / PNOISE_UNIT)
#: pNoise cost of a ring tunnel (~6 bits): ⌈6/6.1⌉ (:295-296)
TUNNEL_PNOISE = math.ceil(6 / PNOISE_UNIT)


@dataclass(frozen=True)
class PtTy:
    """PNoiseCyc p t m zp."""

    pnoise: int
    m: int
    zp: int

    def __repr__(self):
        return f"PtTy(p={self.pnoise}, m={self.m}, zp={self.zp})"


@dataclass(frozen=True)
class FunTy:
    arg: object
    res: object


class NoiseLedger:
    """Modulus-prefix selection for a given chain (the `zqs` type list)."""

    def __init__(self, chain: RnsChain):
        self.chain = chain

    # CTPNoise2Units (PT2CT.hs:233-235)
    def ct_pnoise_to_units(self, p: int) -> int:
        return p + MIN_UNITS

    # Units2CTPNoise (PT2CT.hs:244-246)
    def units_to_ct_pnoise(self, h: int) -> int:
        return h - MIN_UNITS

    # PNoise2Zq = prefix with ≥ p+MinUnits units (PT2CT.hs:248-249)
    def prefix_len(self, p: int) -> int:
        return self.chain.prefix_len_for_units(self.ct_pnoise_to_units(p))

    def qs_for_pnoise(self, p: int) -> tuple[int, ...]:
        return self.chain.qs[: self.prefix_len(p)]

    # TotalUnits (Noise.hs:139)
    def total_units_for(self, p: int) -> int:
        return self.chain.total_units(self.prefix_len(p))

    # PreMul input pnoise: Units2CTPNoise (TotalUnits zqs (CTPNoise2Units (p+MulPNoise)))
    # (PT2CT.hs:163-164)
    def mul_input_pnoise(self, p_out: int) -> int:
        return self.units_to_ct_pnoise(self.total_units_for(p_out + MUL_PNOISE))

    def mul_output_pnoise(self, p_in: int) -> int:
        """Inverse of mul_input_pnoise (smallest p_out whose input matches)."""
        for p in range(p_in + 1):
            if self.mul_input_pnoise(p) == p_in:
                return p
        raise ValueError(f"no output pnoise yields mul input pnoise {p_in}")

    # KSPNoise (PT2CT.hs:136-140) and the hint modulus PNoise2KSZq (:132)
    def ks_pnoise(self, gad: Gadget, p: int) -> int:
        if isinstance(gad, TrivGad):
            return p + KS_ACCUM_PNOISE + MAX_32BIT_UNITS
        if isinstance(gad, BaseBGad):
            return p + KS_ACCUM_PNOISE
        if isinstance(gad, HybridGad):
            # the digit magnitude cancels against the special modulus P
            # (P ≥ max Q_j, she/hybrid.py noise analysis) — no TrivGad
            # digit penalty, same accumulation charge as BaseBGad
            return p + KS_ACCUM_PNOISE
        raise TypeError(f"unknown gadget {gad!r}")

    def hint_qs(self, gad: Gadget, p: int) -> tuple[int, ...]:
        # KSPNoise2Units is the identity on pnoise (hint coefficients are
        # small, PT2CT.hs:237-241)
        n = self.chain.prefix_len_for_units(self.ks_pnoise(gad, p))
        return self.chain.qs[:n]
