"""The plain reference that decides `correct` for configurations with
"system": "bgv_square_chain": a levelled BGV squaring chain, written from
the scheme's definition in plain PyTorch int64 on top of `reference.py`'s
ring, hybrid product and exact rescale. It imports nothing of the port and
takes nothing the port made: it replays the seed's draws (`inputs.py`),
works the secret key, every level's hint and each judged ciphertext out
again, takes each level's chain, dnum and special primes from the
configuration, and judges the port's outputs against its own chain.

A level at L limbs: ct·ct over Ring(qs[:L]), relinearized with hybrid key
switching over Ring(qs[:L] + special primes) (`reference.mul_relin_hybrid`),
then rescaled exactly by q_{L-1} to Ring(qs[:L-1]) (`reference.rescale_exact`).
Draws, in order: the key stream holds the secret key and then every level's
hint, top level first; ciphertext i of the pool is the stream
(seed, CIPHERTEXT, i), its message first.

Over Z_2 the square of a polynomial maps x^j to x^(2j) (mod X^n + 1, where
-1 = 1), so the chain's plaintext is the message's 2^depth-th power, a
permutation-and-fold of its coefficients that `expected_power` computes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark import inputs, reference


class ChainLevel(NamedTuple):
    """One level of the reference's chain: its ring, its extended ring over
    Q·P, the ring after the rescale, dnum and the hint (B, A) [dnum, T, n]."""

    ring: reference.Ring
    ring_ext: reference.Ring
    ring_next: reference.Ring
    dnum: int
    hb: torch.Tensor
    ha: torch.Tensor


class KeyAt(reference.Keys):
    """The secret key over one chain, with the reference's `encrypt` and
    `decrypt` at that chain."""

    def __init__(self, ring: reference.Ring, s_coeffs: np.ndarray):
        self.ring = ring
        self.s = ring.ntt(ring.residues(s_coeffs))


def pool_slots(cfg: dict, traffic: dict) -> int:
    """Slots of the pool: each holds the `batch` fresh ciphertexts of one
    call at the top chain, and the slots together hold at least
    traffic["pool_min_bytes"]."""
    per_slot = traffic["batch"] * inputs.ciphertext_bytes(cfg)
    return max(2, math.ceil(traffic["pool_min_bytes"] / per_slot))


def ciphertext_index(slot: int, row: int, batch: int) -> int:
    """Index of the ciphertext at pool[slot, row] (its stream)."""
    return slot * batch + row


class Chain:
    """The key, every level and the chain of a configuration, worked out
    from the seed, with the products of `mul`."""

    def __init__(self, cfg: dict, seed: int, device, mul=reference.exact_mul):
        n, zp, var, order, qs = cfg["n"], cfg["zp"], cfg["variance"], cfg["order"], cfg["qs"]
        if zp != 2:
            raise ValueError(f"zp={zp}: the squaring chain's plaintext is a fold over Z_2")
        if cfg["key_switching"] != "hybrid":
            raise ValueError("the chain's reference has hybrid key switching")
        if cfg["depth"] != len(cfg["levels"]):
            raise ValueError(f"depth {cfg['depth']}: the configuration lists "
                             f"{len(cfg['levels'])} levels")
        self.cfg = cfg
        rings: dict[tuple, reference.Ring] = {}

        def ring(chain) -> reference.Ring:
            if tuple(chain) not in rings:
                rings[tuple(chain)] = reference.Ring(n, chain, order, device, mul)
            return rings[tuple(chain)]

        rng = inputs.stream(seed, inputs.KEY)
        s = reference.gaussian(rng, var, n)
        self.top = KeyAt(ring(qs), s)
        self.levels = []
        for lv in cfg["levels"]:
            L, ps = lv["L"], lv["special_primes"]
            hb, ha = self._hint(ring(qs[:L] + ps), qs[:L], ps, lv["dnum"], s, rng)
            self.levels.append(ChainLevel(ring(qs[:L]), ring(qs[:L] + ps), ring(qs[:L - 1]),
                                          lv["dnum"], hb, ha))
        self.bottom = KeyAt(self.levels[-1].ring_next, s)

    def _hint(self, ring_ext, qs, ps, dnum, s_coeffs, rng):
        """The level's hint: for group j, B_j + A_j·s = P·g_j·s² + zp·e_j
        over Q·P, drawn from rng (`reference.Keys._hybrid` at this chain)."""
        s = ring_ext.ntt(ring_ext.residues(s_coeffs))
        Q, P = math.prod(qs), math.prod(ps)
        bs, as_ = [], []
        for grp in reference.groups_of(qs, dnum):
            Qj = math.prod(grp)
            Qi = Q // Qj
            g = P * (Qi * pow(Qi % Qj, -1, Qj) % Q) % (Q * P)
            b, a = self.top._hint(ring_ext, s, g, rng, self.cfg["zp"], self.cfg["variance"])
            bs.append(b)
            as_.append(a)
        return torch.stack(bs), torch.stack(as_)

    def encrypt(self, seed: int, indices) -> tuple[torch.Tensor, np.ndarray]:
        """The pool's ciphertexts `indices` [k, 2, L, n] at the top chain and
        their centered message lifts [k, n]."""
        return self.top.encrypt(self.cfg, seed, indices)

    def run(self, ct: torch.Tensor) -> torch.Tensor:
        """The chain: [B, 2, L, n] int64 at the top chain → [B, 2, L − depth,
        n]."""
        zp = self.cfg["zp"]
        for lv in self.levels:
            ct = reference.mul_relin_hybrid(lv.ring, lv.ring_ext, lv.dnum, zp, ct, ct, lv.hb,
                                            lv.ha)
            ct = reference.rescale_exact(lv.ring, lv.ring_next, ct, zp)
        return ct


def expected_power(lifts: np.ndarray, depth: int) -> torch.Tensor:
    """The messages' 2^depth-th powers in Z_2[X]/(X^n + 1): [B, n] → [B, n].
    A square sends coefficient j to 2j for j < n/2 and to 2j − n above, and
    two coefficients that land on one slot add mod 2."""
    m = torch.from_numpy(np.asarray(lifts, dtype=np.int64) % 2)
    n = m.shape[-1]
    for _ in range(depth):
        sq = torch.zeros_like(m)
        sq[..., 0::2] = (m[..., :n // 2] + m[..., n // 2:]) % 2
        m = sq
    return m


def judge(cfg: dict, traffic: dict, seed: int, kept: dict, device) -> dict:
    """Compare the outputs the window kept ({call index: [batch, 2, 2, n]
    int32}) with the reference's chain: residues that differ (`mismatch`),
    decrypted coefficients that are not the message's 2^depth-th power
    (`bad_slots`), and the count of calls compared. Every distinct slot
    runs through the reference's chain in one batch."""
    chain = Chain(cfg, seed, device)
    batch, slots = traffic["batch"], pool_slots(cfg, traffic)
    by_slot: dict[int, list] = {}
    for k, out in kept.items():
        by_slot.setdefault(k % slots, []).append(out)
    order = sorted(by_slot)
    ct, lifts = chain.encrypt(seed, [ciphertext_index(slot, r, batch)
                                     for slot in order for r in range(batch)])
    want = chain.run(ct).reshape(len(order), batch, 2, -1, cfg["n"])
    want_msg = expected_power(lifts, cfg["depth"]).to(want.device).reshape(len(order), batch, -1)
    mismatch = bad = 0
    for i, slot in enumerate(order):
        for out in by_slot[slot]:
            got = (out.to(device=want.device, dtype=torch.int64) & 0xFFFFFFFF)
            got = got.reshape(want[i].shape)
            mismatch += int((got != want[i]).sum())
            bad += int((chain.bottom.decrypt(got, cfg["zp"]) != want_msg[i]).sum())
    return {"mismatch": mismatch, "bad_slots": bad, "compared_calls": len(kept)}
