"""The system under test of configurations with "system": "bgv_square_chain":
one tenant's levelled BGV squaring chain through the port's chain entry,
`examples.deep_circuit.square_chain`: at every level `hybrid.mul_relin_hybrid`
(the ciphertext squared, relinearized with hybrid key switching) and
`fast.rescale` by one limb, called eagerly as a user's code calls them.

Set-up runs the port's key generation from the seed's key stream, makes
every level's parameters and hint from the same stream
(`deep_circuit.chain_keys`; each level's dnum and special primes must be
the configuration's), and fills a pool of fresh ciphertexts at the top
chain on the card; call k runs the chain on slot k mod slots. The reference
(`reference_chain.judge`) works the same key, hints and ciphertexts out
again.
"""

from __future__ import annotations

import sys
import time

import torch

from alchemy_tpu_torch.examples import deep_circuit
from alchemy_tpu_torch.examples.deep_circuit import chain_keys, key_at
from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.keys import gaussian_coeffs
from benchmark import inputs, reference_chain
from benchmark.reference_chain import judge  # noqa: F401  (the harness's judge for this system)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        t0 = time.perf_counter()
        if cfg["key_switching"] != "hybrid":
            raise ValueError("the chain's levels are listed for hybrid key switching")
        n, var, zp = cfg["n"], cfg["variance"], cfg["zp"]
        p = fast.FastParams(n=n, qs=tuple(cfg["qs"]), zp=zp, impl=cfg["order"])
        key_rng = inputs.stream(seed, inputs.KEY)
        s_int = gaussian_coeffs(key_rng, var, n)
        self.s = key_at(p, s_int, device)
        self.levels = chain_keys(p, cfg["depth"], s_int, key_rng, "hybrid", device, var)
        for lv, want in zip(self.levels, cfg["levels"], strict=True):
            got = {"L": len(lv.p.qs), "dnum": lv.hk.dnum, "special_primes": list(lv.hk.ps)}
            if got != want:
                raise ValueError(f"level at L = {want['L']}: the configuration gives {want}, "
                                 f"HybridKS.make gives {got}")
        t_keys = time.perf_counter()
        batch, self.slots = traffic["batch"], reference_chain.pool_slots(cfg, traffic)
        self.pool = torch.empty((self.slots, batch, 2, len(p.qs), n), dtype=torch.int32,
                                device=device)
        for slot in range(self.slots):
            for row in range(batch):
                rng = inputs.stream(seed, inputs.CIPHERTEXT,
                                    reference_chain.ciphertext_index(slot, row, batch))
                msg = inputs.message(rng, zp, n)
                self.pool[slot, row] = fast.encrypt(p, self.s, msg, rng, var)
        print(f"[setup] key and {len(self.levels)} levels' hints {t_keys - t0:.3f} s, pool of "
              f"{batch * self.slots} ciphertexts {time.perf_counter() - t_keys:.3f} s",
              file=sys.stderr, flush=True)

    def call(self, k: int) -> torch.Tensor:
        """The timed call: the chain on the ciphertexts in slot k mod slots,
        [batch, 2, L − depth, n]."""
        return deep_circuit.square_chain(self.levels, self.pool[k % self.slots])

    def close(self) -> None:
        """Free the program's state: the key, every level's hint and the pool."""
        del self.s, self.levels, self.pool
