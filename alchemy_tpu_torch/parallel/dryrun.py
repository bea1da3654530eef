"""One sharded step of each distributed op on tiny shapes — the port's
counterpart of `__graft_entry__.py`'s `dryrun_multichip` (:36).

`dryrun_multichip(n)` runs on every rank of an initialised world of n ranks
(`parallel/multihost.init_multihost`): it lays them out as the
('batch', 'limb', 'coeff') mesh of `pick_mesh_shape(n)` and executes, with
the real placements used at scale (DP over the ciphertext batch, limb-TP
over the RNS chain with hints sharded over 'limb', coefficient-SP with the
distributed 4-step NTT), the fused mul+relin, the distributed rescale and
one hybrid key-switching level.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import distribute_tensor

from alchemy_tpu_torch.parallel.dist import (
    CT_PLACEMENTS,
    HINT_PLACEMENTS,
    DistConfig,
    make_dist_mul_relin,
    make_dist_mul_relin_hybrid,
    make_dist_rescale,
)
from alchemy_tpu_torch.parallel.mesh import make_mesh, pick_mesh_shape
from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.fast import FastParams
from alchemy_tpu_torch.she.hybrid import HybridKS, hybrid_keygen_hint, pick_dnum


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """Run the three sharded steps at n = 2^6 with 2·limb limbs from seed 0
    (the JAX dry run's sizes and sampling order, in the port's default slot
    order) and return their outputs, DTensors [B, 2, L, n] with
    CT_PLACEMENTS: {"mul_relin", "rescale", "hybrid"}."""
    batch, limb, coeff = pick_mesh_shape(n_devices)
    mesh = make_mesh((batch, limb, coeff), device_type)
    dev = torch.device(device_type)

    nlimb = 2 * limb
    log_n = 6
    p = FastParams.make(log_n, nlimb, zp=2)
    # n1 sized so the all_to_all split (n1 by C) and the row constraint
    # (n/C a multiple of n1) both hold
    n1 = max(coeff, 1) * 4
    cfg = DistConfig(p=p, n1=n1, n2=p.n // n1)

    rng = np.random.default_rng(0)
    s = fast.keygen(p, rng, device=dev)
    hb, ha = fast.relin_hint(p, s, rng)
    B = batch * 2
    ct_batch = torch.stack([fast.encrypt(p, s, rng.integers(0, p.zp, p.n), rng)
                            for _ in range(B)])          # [B, 2, L, n]

    def sharded(x, placements):
        return distribute_tensor(x, mesh, placements, src_data_rank=None)

    cts = sharded(ct_batch, CT_PLACEMENTS)
    out = make_dist_mul_relin(cfg, mesh)(cts, cts, sharded(hb, HINT_PLACEMENTS),
                                         sharded(ha, HINT_PLACEMENTS))
    assert out.shape == (B, 2, nlimb, p.n), out.shape

    # one full level: the fused step above + the distributed rescale, the
    # padded-chain layout of the sharded deep circuit
    out2 = make_dist_rescale(cfg, mesh, active=nlimb)(out)
    assert out2.shape == (B, 2, nlimb, p.n), out2.shape

    # one deep-configuration level with HYBRID key-switching on the same
    # mesh: dnum digit groups over the special modulus P, digit NTTs at the
    # extended chain Q·P and the distributed joint P-rescale
    alpha = -(-nlimb // pick_dnum(nlimb))
    k_sp = -(-alpha // limb) * limb  # keep T = L + k_sp divisible by 'limb'
    hk = HybridKS.make(p, k_sp=k_sp)
    _, (hhb, hha) = hybrid_keygen_hint(hk, rng, device=dev)
    outh = make_dist_mul_relin_hybrid(hk, cfg, mesh)(
        cts, cts, sharded(hhb, HINT_PLACEMENTS), sharded(hha, HINT_PLACEMENTS))
    assert outh.shape == (B, 2, nlimb, p.n), outh.shape
    return {"mul_relin": out, "rescale": out2, "hybrid": outh}
