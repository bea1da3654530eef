"""The yardstick of the kernels' roofline shares: the peaks of one NVIDIA
H100 SXM and the bytes and 32-bit multiplies each of the port's kernels
needs at a shape, frozen copies of `chip_smoke.py` (peaks and `ntt_muls`,
`tensor_cost`, `rescale_cost`, `bound`: lines 204-241; kernel B: 384-395;
`grid_cost`: 460-465; kernel 4's `k4_cost`: 546-549).

Each count is of what the algorithm needs at the shape, never of what a
kernel re-reads: every input byte read once, every output byte written
once, and for each modular operation the fewest 32-bit multiplies it needs.
The bound is the larger of bytes over HBM bandwidth and multiplies over
the card's integer multiply rate at its maximum SM clock.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
SMS, IMUL_PER_SM_CLOCK = 132, 64   # 32-bit integer multiplies per SM and clock, cc 9.0
# A product of two variable residues (the low and high words of the
# product, the quotient estimate, the estimate times q), a product by a
# constant with its Shoup companion, a reduction of any uint32 (the
# quotient estimate and the estimate times q).
MUL_VAR, MUL_CONST, REDUCE = 4, 3, 2


def ntt_muls(n: int) -> int:
    """32-bit multiplies of one radix-2 NTT: one product by a constant
    twiddle a butterfly."""
    return MUL_CONST * (n // 2) * (n.bit_length() - 1)


def tensor_cost(Bt: int, L: int, n: int) -> tuple[int, int]:
    """(bytes, multiplies) of kernel A `tensor_intt` on [Bt, L, n]: four
    rows in, three out, twiddles and companions, the slot table; per word
    three products of the tensor, the inverse NTT and its scale by n^-1."""
    return (4 * (7 * Bt * L * n + 2 * L * n + n),
            Bt * L * ((3 * MUL_VAR + MUL_CONST) * n + ntt_muls(n)))


def digit_relin_cost(Bt: int, L: int, n: int, shoup: bool) -> tuple[int, int]:
    """(bytes, multiplies) of kernel B `digit_relin` on [Bt, L, n]: c2c, c0
    and c1 in, two rows out, the L x L hint rows of B and A (values, and
    Shoup companions), twiddles and the slot table; per (ciphertext, limb,
    digit) the digit's reduction, its NTT and two hint products."""
    hint_words, hint_mul = (4, MUL_CONST) if shoup else (2, MUL_VAR)
    tables = 4 * (2 * L * n + n)
    return (4 * (5 * Bt * L * n + hint_words * L * L * n) + tables,
            Bt * L * L * ((REDUCE + 2 * hint_mul) * n + ntt_muls(n)))


def hybrid_digit_relin_cost(Bt: int, L: int, T: int, dnum: int, n: int,
                            shoup: bool) -> tuple[int, int]:
    """(bytes, multiplies) of kernel 4 `hybrid_digit_relin`: the L Garner
    digit rows in, the base-extension constants, the dnum x T hint rows,
    twiddles and the slot table, the two [Bt, T, n] sums out; per word of
    each extended digit its L-term base extension, and per digit group its
    NTT and two hint products."""
    hint_words, hint_mul = (4, MUL_CONST) if shoup else (2, MUL_VAR)
    return (4 * (Bt * L * n + 2 * T * L + hint_words * dnum * T * n + 2 * T * n + n
                 + 2 * Bt * T * n),
            Bt * T * (MUL_CONST * L * n + dnum * (ntt_muls(n) + 2 * hint_mul * n)))


def rescale_cost(G: int, L: int, K: int, n: int) -> tuple[int, int]:
    """(bytes, multiplies) of kernel 7 `rescale_fwd` on [G, L, n] with K
    dropped limbs: the L coefficient rows, the K Garner digit rows and the
    three sign rows in, L rows out, twiddles, the slot table and the
    constants; per word K + 2 Shoup products and the forward NTT."""
    return (4 * (G * (2 * L + K + 3) * n + 2 * L * n + n + L * (4 + 2 * K)),
            G * L * (MUL_CONST * (K + 2) * n + ntt_muls(n)))


def grid_cost(inverse: bool, G: int, T: int, n: int) -> tuple[int, int]:
    """(bytes, multiplies) of a standalone transform (kernels 5, 6, 8, 9) on
    [G, T, n]: rows in and out, twiddles and companions, the slot table; per
    word its reduction (and the inverse's scale by n^-1), and the NTT."""
    return (4 * (2 * G * T * n + 2 * T * n + n),
            G * T * ((REDUCE + (MUL_CONST if inverse else 0)) * n + ntt_muls(n)))


def bound(nbytes: float, muls: float, clock_hz: float) -> tuple[float, str]:
    """(the least ms the card could take, what sets it)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, muls / (SMS * IMUL_PER_SM_CLOCK * clock_hz)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"
