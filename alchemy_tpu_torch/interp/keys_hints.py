"""Typed key/hint cache (reference Interpreter/KeysHints.hs).

The reference memoizes secret keys and quad-circ hints *by type* in a
Dynamic-list monad; here the cache keys are the corresponding parameter
tuples. Semantics preserved:
- keys memoized per ciphertext ring index m' (KeysHints.hs:89-96), generated
  with variance r/√φ(m') where r is the context's Gaussian parameter
  (`evalKeysHints 3.0`-style, :85-87);
- quad-circ hints memoized per (m', hint modulus, gadget) (:101-113);
- tunnel hints NOT memoized (:116-129).

A copy of `alchemy_tpu/interp/keys_hints.py`, except that the context
backend defaults to the card (`get_backend("torch")`) instead of golden numpy.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.interp.accumulator import DictAccumulator
from alchemy_tpu_torch.nt.factor import totient
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.ct import CT
from alchemy_tpu_torch.she.gadget import Gadget
from alchemy_tpu_torch.she.keys import SK
from alchemy_tpu_torch.she.linear import LinearMap
from alchemy_tpu_torch.she.tunnel import TunnelHint, tunnel_hint


class KeysHints:
    """The run context for compilation, encryption and decryption.

    Keys and hints are append-only `DictAccumulator` stores — the
    reification of the reference's KeysHintsT accumulator stack
    (KeysHints.hs:42 = StateT Keys (StateT Hints (ReaderT v m)) over
    MonadAccumulator; interp/accumulator.py). Generation appends; lookups
    are reads; nothing is ever rebound. `bk` defaults to
    `get_backend("torch")`, the card."""

    def __init__(self, variance_param: float, seed: int = 0, bk=None):
        if bk is None:
            from alchemy_tpu_torch.backend import get_backend

            bk = get_backend("torch")
        self.r = float(variance_param)
        self.rng = np.random.default_rng(seed)
        self.bk = bk
        self.keys: DictAccumulator = DictAccumulator()
        self.hints: DictAccumulator = DictAccumulator()

    # -- keys ---------------------------------------------------------------

    def svar(self, m_prime: int) -> float:
        """r/√φ(m') (KeysHints.hs:85-87)."""
        return self.r / math.sqrt(totient(m_prime))

    def get_key(self, m_prime: int) -> SK:
        if m_prime not in self.keys:
            self.keys[m_prime] = SK.generate(m_prime, self.svar(m_prime), self.rng)
        return self.keys[m_prime]

    def lookup_key(self, m_prime: int) -> Optional[SK]:
        return self.keys.get(m_prime)

    # -- hints --------------------------------------------------------------

    def _gen_bk(self):
        """Hint generation backend: always golden (eager numpy — avoids
        one small launch per op at compile time); results are converted
        wholesale to the context backend (she/convert.py)."""
        from alchemy_tpu_torch.backend import golden_backend

        return golden_backend()

    def _converted(self, obj):
        if self.bk.name == "golden":
            return obj
        from alchemy_tpu_torch.she.convert import to_backend

        return to_backend(obj, self.bk)

    def get_quad_circ_hint(self, m_prime: int, qs: tuple[int, ...], gad: Gadget, zp: int):
        key = ("quad", m_prime, qs, gad, zp)
        if key not in self.hints:
            sk = self.get_key(m_prime)
            hint = bgv.ks_quad_circ_hint(sk, gad, qs, zp, self.rng, self._gen_bk())
            self.hints[key] = self._converted(hint)
        return self.hints[key]

    def get_tunnel_hint(self, f: LinearMap, r_p: int, s_p: int,
                        qs: tuple[int, ...], gad: Gadget, zp: int) -> TunnelHint:
        sk_out = self.get_key(s_p)
        sk_in = self.get_key(r_p)
        from alchemy_tpu_torch.she.convert import to_backend as _tb
        from alchemy_tpu_torch.backend import golden_backend

        f_gold = f if self.bk.name == "golden" else _tb(f, golden_backend())
        hint = tunnel_hint(f_gold, sk_out, sk_in, gad, qs, zp, self.rng, self._gen_bk())
        return self._converted(hint)

    # -- encryption boundary (PT2CT.hs:76-99) -------------------------------

    def encrypt(self, pt: Cyc, m_prime: int, qs: tuple[int, ...]) -> CT:
        sk = self.get_key(m_prime)
        return bgv.encrypt(sk, pt, m_prime, qs, self.rng)

    def decrypt(self, ct: CT) -> Optional[Cyc]:
        sk = self.lookup_key(ct.m_prime)
        if sk is None:
            return None
        return bgv.decrypt(sk, ct)
