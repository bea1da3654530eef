"""What a run is made from, as a function of `--seed`: the random streams
that the system and the reference both draw from, and the layout of the
input pool. Both sides import this module; it imports nothing of the port.

Every stream is a numpy Generator seeded with (seed, tag, index), so the
reference can replay the draws of one ciphertext without the others:
tag 0 is the key (and, for hybrid key switching, its hint), tag 1 the
CRT-gadget hint, tag 2 the i-th ciphertext of the pool: its message
(uniform mod zp, drawn first) and then its encryption's randomness.
"""

from __future__ import annotations

import math

import numpy as np

KEY, HINT, CIPHERTEXT = 0, 1, 2


def stream(seed: int, tag: int, index: int = 0) -> np.random.Generator:
    """The Generator of one input; any whole seed, negative or above 2^63."""
    return np.random.default_rng([seed % (1 << 64), tag, index])


def message(rng: np.random.Generator, zp: int, n: int) -> np.ndarray:
    """A plaintext of n coefficients mod zp (int64), the first draw of a
    ciphertext's stream."""
    return rng.integers(0, zp, size=n, dtype=np.int64)


def ciphertext_bytes(cfg: dict) -> int:
    """Bytes of one fresh ciphertext [2, L, n] int32."""
    return 2 * len(cfg["qs"]) * cfg["n"] * 4


def pool_slots(cfg: dict, traffic: dict) -> int:
    """Slots of the pool: each slot holds the two operands of one call,
    [2, batch, 2, L, n], and the slots together hold at least
    traffic["pool_min_bytes"], so that a call finds none of its inputs in
    the card's L2."""
    per_slot = 2 * traffic["batch"] * ciphertext_bytes(cfg)
    return max(2, math.ceil(traffic["pool_min_bytes"] / per_slot))


def ciphertext_index(slot: int, operand: int, row: int, batch: int) -> int:
    """Index of the ciphertext at pool[slot, operand, row] (its stream)."""
    return (2 * slot + operand) * batch + row
