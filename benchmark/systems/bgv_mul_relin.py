"""The system under test of configurations with "system": "bgv_mul_relin":
one tenant's BGV multiply + relinearize through the port's public entry,
`she.fast.mul_relin` (CRT-gadget hints, "key_switching": "trivgad") or
`she.hybrid.mul_relin_hybrid` ("hybrid"), called eagerly as a user's code
calls it.

Set-up runs the port's own key generation, hints and encryptions from the
seed's streams (`inputs.py`) and fills a pool of ciphertext pairs on the
card; call k multiplies the pair in slot k mod slots. The reference
(`reference.judge`) works the same keys, hints and ciphertexts out again.
"""

from __future__ import annotations

import sys
import time

import torch

from alchemy_tpu_torch.she import fast, hybrid
from benchmark import inputs
from benchmark.reference import judge  # noqa: F401  (the harness's judge for this system)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        t0 = time.perf_counter()
        n, var, zp = cfg["n"], cfg["variance"], cfg["zp"]
        self.p = fast.FastParams(n=n, qs=tuple(cfg["qs"]), zp=zp, impl=cfg["order"])
        key_rng = inputs.stream(seed, inputs.KEY)
        if cfg["key_switching"] == "trivgad":
            self.s = fast.keygen(self.p, key_rng, var, device=device)
            self.hints = fast.relin_hint(self.p, self.s, inputs.stream(seed, inputs.HINT), var,
                                         shoup=cfg["shoup_hints"])
        else:
            self.hk = hybrid.HybridKS(p=self.p, dnum=cfg["dnum"],
                                      ps=tuple(cfg["special_primes"]))
            self.s, self.hints = hybrid.hybrid_keygen_hint(self.hk, key_rng, var, var,
                                                           device=device)
            if cfg["shoup_hints"]:
                self.hints = tuple(fast.shoup_precompute(h, self.hk.pe.qs) for h in self.hints)
        self.hybrid = cfg["key_switching"] == "hybrid"
        t_keys = time.perf_counter()
        batch, self.slots = traffic["batch"], inputs.pool_slots(cfg, traffic)
        self.pool = torch.empty((self.slots, 2, batch, 2, len(self.p.qs), n),
                                dtype=torch.int32, device=device)
        for slot in range(self.slots):
            for operand in range(2):
                for row in range(batch):
                    rng = inputs.stream(seed, inputs.CIPHERTEXT,
                                        inputs.ciphertext_index(slot, operand, row, batch))
                    msg = inputs.message(rng, zp, n)
                    self.pool[slot, operand, row] = fast.encrypt(self.p, self.s, msg, rng, var)
        print(f"[setup] keys and hints {t_keys - t0:.3f} s, pool of {2 * batch * self.slots} "
              f"ciphertexts {time.perf_counter() - t_keys:.3f} s", file=sys.stderr, flush=True)

    def call(self, k: int) -> torch.Tensor:
        """The timed call: the product of the pair in slot k mod slots,
        [batch, 2, L, n]."""
        a, b = self.pool[k % self.slots]
        if self.hybrid:
            return hybrid.mul_relin_hybrid(self.hk, a, b, *self.hints)
        return fast.mul_relin(self.p, a, b, *self.hints)

    def close(self) -> None:
        """Free the program's state: keys, hints and the pool."""
        del self.s, self.hints, self.pool
