"""The plain reference of configurations with "system": "bgv_tenants": many
tenants' TrivGad products, each row judged under its own tenant's key. Like
`reference.py`, whose rings, keys, products and decryption it uses, it
imports nothing of the port and takes nothing the port made: it replays the
seed's draws and works each row's tenant's key, hint and ciphertexts out
again.

What a run is made from, beyond `inputs.py` (the system draws the same):

- tenant t's seed, `tenant_seed(seed, t)`: the first `integers(0, 2^63)` of
  the numpy Generator seeded [seed mod 2^64, TENANT_SEED, t]. Tenant t's
  key, hint and ciphertexts are `inputs.py`'s streams of that seed: the key
  `stream(ts, KEY)`, the hint `stream(ts, HINT)`, and the ciphertext at
  pool[slot, operand, row] `stream(ts, CIPHERTEXT, ciphertext_index(slot,
  operand, row, batch))`, which encrypts under tenant t's key;
- the tenants of slot j's rows, `row_tenants`: `batch` draws with
  replacement, Zipf(s) over the tenants (P(t) proportional to (t + 1)^-s),
  from the Generator seeded [seed mod 2^64, ROW_TENANTS, j].
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import inputs, reference

TENANT_SEED, ROW_TENANTS = 3, 4


def tenant_seed(seed: int, tenant: int) -> int:
    """The seed of tenant's key, hint and ciphertext streams."""
    return int(np.random.default_rng([seed % (1 << 64), TENANT_SEED, tenant]).integers(0, 1 << 63))


def zipf(tenants: int, s: float) -> np.ndarray:
    """P(t) of each tenant t < tenants, proportional to (t + 1)^-s."""
    w = np.arange(1, tenants + 1, dtype=np.float64) ** -s
    return w / w.sum()


def row_tenants(seed: int, slot: int, batch: int, tenants: int, s: float) -> list[int]:
    """The tenant of each row of pool slot `slot`."""
    rng = np.random.default_rng([seed % (1 << 64), ROW_TENANTS, slot])
    return [int(t) for t in rng.choice(tenants, size=batch, p=zipf(tenants, s))]


def judge(cfg: dict, traffic: dict, seed: int, kept: dict, device) -> dict:
    """Compare the outputs the window kept ({call index: [batch, 2, L, n]
    int32}) with the reference's, row by row under each row's tenant:
    residues that differ (`mismatch`), coefficients that do not decrypt under
    the row's own tenant's key to m_a*m_b mod zp (`bad_slots`), and the count
    of calls compared. Each tenant's key and hint are worked out once."""
    batch, slots = traffic["batch"], inputs.pool_slots(cfg, traffic)
    rows: dict[int, list] = {}              # tenant -> [(call, slot, row)]
    for k in kept:
        ids = row_tenants(seed, k % slots, batch, cfg["tenants"], traffic["tenant_zipf_s"])
        for r, t in enumerate(ids):
            rows.setdefault(t, []).append((k, k % slots, r))
    mismatch = bad = 0
    for t, mine in sorted(rows.items()):
        ts = tenant_seed(seed, t)
        keys = reference.Keys(cfg, ts, device)
        pairs = sorted({(slot, r) for _, slot, r in mine})
        at = {pair: i for i, pair in enumerate(pairs)}
        ct_a, lift_a = keys.encrypt(cfg, ts, [inputs.ciphertext_index(s, 0, r, batch)
                                              for s, r in pairs])
        ct_b, lift_b = keys.encrypt(cfg, ts, [inputs.ciphertext_index(s, 1, r, batch)
                                              for s, r in pairs])
        want = keys.mul_relin(cfg, ct_a, ct_b)
        want_msg = reference.negacyclic_mod(lift_a, lift_b, cfg["qs"][0], cfg["zp"], device)
        pick = [at[(slot, r)] for _, slot, r in mine]
        got = torch.stack([kept[k][r].to(device=want.device, dtype=torch.int64) & 0xFFFFFFFF
                           for k, _, r in mine]).reshape(len(mine), *want.shape[1:])
        mismatch += int((got != want[pick]).sum())
        bad += int((keys.decrypt(got, cfg["zp"]) != want_msg[pick]).sum())
        del keys, want
    return {"mismatch": mismatch, "bad_slots": bad, "compared_calls": len(kept)}
