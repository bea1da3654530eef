"""The yardstick of kernel B's tenant-indexed form (`digit_relin_tenants`),
beside the frozen `roofline.py`: B's count at the shape, with the L x L hint
rows read once for each distinct tenant among the batch's rows, and the
rows' tenant ids."""

from __future__ import annotations

from benchmark import roofline


def digit_relin_tenants_cost(Bt: int, L: int, n: int, shoup: bool,
                             distinct: float) -> tuple[float, int]:
    """(bytes, multiplies) of `digit_relin_tenants` on [Bt, L, n] whose rows
    hold `distinct` tenants (a mean over calls may be fractional):
    `roofline.digit_relin_cost`, whose bytes hold one tenant's hint rows,
    plus those of the other distinct tenants and Bt int32 tenant ids."""
    nbytes, muls = roofline.digit_relin_cost(Bt, L, n, shoup)
    hint_words = 4 if shoup else 2
    return nbytes + 4 * ((distinct - 1) * hint_words * L * L * n + Bt), muls
