"""Many tenants' evaluation keys on one card, and batches of products
gathered across tenants.

An evaluation server holds the relinearization hints of many clients
(tenants) and multiplies whatever ciphertext pairs are waiting, of any
clients, in one launch: `fast.mul_relin(p, ct_a, ct_b, keys.batch(ids))`
relinearizes row r under tenant ids[r]'s hints through kernel B's
tenant-indexed form (`backend/cuda/mul_relin.py` `digit_relin(...,
tenant=)`, the launch `digit_relin_tenants`; its plain form on the CPU). Row r of the result is what `fast.mul_relin` gives
for row r alone with that tenant's hints, bit for bit.

`TenantKeys` is the key store: one allocation of T tenants' CRT-gadget
Shoup hint pairs, [2 (B, A), 2 (values, companions), T, L, L, n] int32, on
the device the caller names. `TenantKeys.batch` turns a host list of
per-row tenant ids into a `TenantBatch`: the ids as an int32 tensor on that
device, checked on the host against the tenants added, and the count of
distinct tenants (the `mul_relin` span's `tenants`), so a product reads
nothing back from the card.
"""

from __future__ import annotations

import operator
from dataclasses import dataclass
from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from alchemy_tpu_torch.she.fast import FastParams


@dataclass(frozen=True)
class TenantBatch:
    """What `fast.mul_relin` takes in place of one hint pair: the key store,
    the tenant of each row ([rows] int32 on the keys' device) and the count
    of distinct tenants among them."""

    keys: TenantKeys
    index: torch.Tensor
    tenants: int


class TenantKeys:
    """T tenants' relinearization hints (`fast.relin_hint(shoup=True)`) for
    the ring and chain of p, in one allocation on `device`."""

    def __init__(self, p: FastParams, tenants: int, device="cuda"):
        if tenants < 1:
            raise ValueError(f"tenants={tenants}: want at least one")
        L = len(p.qs)
        self.n, self.qs, self.device = p.n, tuple(p.qs), torch.device(device)
        self.table = torch.zeros((2, 2, tenants, L, L, p.n), dtype=torch.int32,
                                 device=self.device)
        self.present = [False] * tenants

    @property
    def tenants(self) -> int:
        return len(self.present)

    @property
    def nbytes(self) -> int:
        """Bytes of the hint tables on the device."""
        return self.table.numel() * self.table.element_size()

    @property
    def hints(self) -> tuple:
        """(hint_b, hint_a), each a (values, companions) pair of [T, L, L, n]
        tables: kernel B's tenant-indexed form takes them so."""
        return (self.table[0, 0], self.table[0, 1]), (self.table[1, 0], self.table[1, 1])

    def _tenant(self, tenant) -> int:
        try:
            t = operator.index(tenant)
        except TypeError:
            t = -1
        if not 0 <= t < self.tenants:
            raise ValueError(f"tenant {tenant!r}: want an integer in [0, {self.tenants})")
        return t

    def add(self, tenant: int, hints) -> None:
        """Store tenant's hints: (hint_b, hint_a), each a (values,
        companions) pair of int32 tensors [L, L, n], or of any layout with
        those leading dims and L·L·n words (as `fast.kernel_hint` takes)."""
        t = self._tenant(tenant)
        L = len(self.qs)
        pairs = hints if isinstance(hints, (tuple, list)) and len(hints) == 2 else ()
        words = [h for pair in pairs if isinstance(pair, (tuple, list)) and len(pair) == 2
                 for h in pair]
        if len(words) != 4 or not all(
                isinstance(h, torch.Tensor) and h.dtype == torch.int32 and h.shape[:2] == (L, L)
                and h.numel() == L * L * self.n for h in words):
            raise ValueError(f"tenant {t}: want (hint_b, hint_a), each a Shoup pair of int32 "
                             f"[{L}, {L}, {self.n}] tensors")
        for k, h in enumerate(words):
            self.table[k // 2, k % 2, t].copy_(h.reshape(L, L, self.n))
        self.present[t] = True

    def batch(self, ids) -> TenantBatch:
        """The batch of rows whose tenants are ids (host ints, one a row, each
        added before)."""
        ids = tuple(map(self._tenant, ids))
        for t in ids:
            if not self.present[t]:
                raise ValueError(f"tenant {t}: no hints added")
        index = torch.tensor(ids, dtype=torch.int32).to(self.device)
        return TenantBatch(self, index, len(set(ids)))
