"""Number theory for cyclotomic rings (host-side, exact Python ints): the
surface of `alchemy_tpu/nt/__init__.py`."""

from alchemy_tpu_torch.nt.factor import (
    divides,
    factorize,
    fgcd,
    is_prime,
    prime_power_factors,
    totient,
)
from alchemy_tpu_torch.nt.primes import (
    find_ntt_prime,
    primitive_root,
    root_of_unity,
    units_of_modulus,
)

__all__ = [
    "factorize",
    "totient",
    "is_prime",
    "divides",
    "fgcd",
    "prime_power_factors",
    "find_ntt_prime",
    "primitive_root",
    "root_of_unity",
    "units_of_modulus",
]
