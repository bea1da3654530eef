"""The system under test of configurations with "system": "bgv_tenants": a
multi-tenant evaluation server, cfg["tenants"] clients' TrivGad evaluation
keys on the card in the port's key store (`she.tenants.TenantKeys`), and
each call one batch of waiting products of any clients through the port's
public entry, `she.fast.mul_relin(p, ct_a, ct_b, batch)`, which runs kernel
A and kernel B's tenant-indexed form.

Set-up, from the seed (the derivations are `reference_tenants.py`'s, which
the reference replays): each tenant t draws its key and Shoup hints from
`inputs.py`'s KEY and HINT streams of its own seed `tenant_seed(seed, t)`,
and they go to the key store; each pool slot's rows take their tenants from
`row_tenants` (Zipf(traffic["tenant_zipf_s"]) over the tenants, a stream of
its own tag), and row r of slot j holds a pair encrypted under its tenant's
key from that tenant's CIPHERTEXT streams; each slot's `TenantKeys.batch` is
built once. Call k multiplies the pair of slot k mod slots.
"""

from __future__ import annotations

import sys
import time

import torch

from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.tenants import TenantKeys
from benchmark import inputs
from benchmark.reference_tenants import (  # noqa: F401  (judge: the harness's judge)
    judge,
    row_tenants,
    tenant_seed,
)


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        if cfg["key_switching"] != "trivgad" or not cfg["shoup_hints"]:
            raise ValueError("bgv_tenants: the key store holds TrivGad Shoup hint pairs")
        t0 = time.perf_counter()
        n, var, zp, T = cfg["n"], cfg["variance"], cfg["zp"], cfg["tenants"]
        self.p = fast.FastParams(n=n, qs=tuple(cfg["qs"]), zp=zp, impl=cfg["order"])
        self.keys = TenantKeys(self.p, T, device)
        seeds, secrets = [tenant_seed(seed, t) for t in range(T)], []
        for t, ts in enumerate(seeds):
            s = fast.keygen(self.p, inputs.stream(ts, inputs.KEY), var, device=device)
            self.keys.add(t, fast.relin_hint(self.p, s, inputs.stream(ts, inputs.HINT), var,
                                             shoup=True))
            secrets.append(s)
        t_keys = time.perf_counter()
        batch, self.slots = traffic["batch"], inputs.pool_slots(cfg, traffic)
        self.pool = torch.empty((self.slots, 2, batch, 2, len(self.p.qs), n),
                                dtype=torch.int32, device=device)
        self.batches = []
        for slot in range(self.slots):
            ids = row_tenants(seed, slot, batch, T, traffic["tenant_zipf_s"])
            for operand in range(2):
                for row, t in enumerate(ids):
                    rng = inputs.stream(seeds[t], inputs.CIPHERTEXT,
                                        inputs.ciphertext_index(slot, operand, row, batch))
                    msg = inputs.message(rng, zp, n)
                    self.pool[slot, operand, row] = fast.encrypt(self.p, secrets[t], msg, rng,
                                                                 var)
            self.batches.append(self.keys.batch(ids))
        tenants = sum(b.tenants for b in self.batches) / self.slots
        print(f"[setup] {T} tenants' keys and hints ({self.keys.nbytes} B) {t_keys - t0:.3f} s, "
              f"pool of {2 * batch * self.slots} ciphertexts, {tenants:.2f} tenants a slot, "
              f"{time.perf_counter() - t_keys:.3f} s", file=sys.stderr, flush=True)

    def call(self, k: int) -> torch.Tensor:
        """The timed call: the products of slot k mod slots, each row
        relinearized under its tenant's hints, [batch, 2, L, n]."""
        a, b = self.pool[k % self.slots]
        return fast.mul_relin(self.p, a, b, self.batches[k % self.slots])

    def close(self) -> None:
        """Free the program's state: the key store, the batches and the pool."""
        del self.keys, self.batches, self.pool
