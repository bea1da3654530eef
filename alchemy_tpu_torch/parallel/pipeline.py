"""PP — level-pipeline parallelism for deep ciphertext chains — port of
`alchemy_tpu/parallel/pipeline.py` on torch.distributed.

A depth-D mul+relin+rescale chain is sequential per ciphertext, but a BATCH
of independent ciphertexts pipelines GPipe-style: the mesh axis 'stage'
owns D/S consecutive levels each, micro-batches flow stage→stage over one
point-to-point hop per tick, and every stage holds ONLY its own levels'
relinearization hints (hint bytes per rank drop by S×).

Residency: the input is SHARDED over 'stage' along the micro-batch axis
(each stage holds M/S micro-batches; one owner-masked all_reduce per tick
delivers micro-batch t to stage 0), and the output stays resident on the
last stage — nothing is replicated.

Layout: the padded deep-chain convention of `parallel/dist.py` —
ciphertexts stay at the full allocation [mb, 2, L0, n] with the active limb
prefix shrinking one row per level. A stage's level is the port's
`fast.mul_relin` on the padded chain (kernels A and B on the card; the JAX
stage's `_mul_relin_jnp` gives the same residues) and `rescale_padded`
(`fast._intt_p` / `_ntt_p`: kernels 9 and 8 in the "mxu" order, 5 and 6 in
"pallas" and "vpu"); the zero hint rows beyond a level's active prefix keep
the padded rows zero. Torch has no shard_map: every rank runs its own
stage's loop; a stage skips its levels on the ticks where it holds no
micro-batch (the JAX stage computes them on zeros, which stay zero).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from alchemy_tpu_torch.backend.modarith import _cond_sub, narrow, qcol, shoup_const, widen
from alchemy_tpu_torch.convert import to_torch
from alchemy_tpu_torch.parallel.dist import _all_reduce, _device, _ppermute
from alchemy_tpu_torch.she import fast
from alchemy_tpu_torch.she.fast import FastParams


def _level_consts(p: FastParams, level: int):
    """Numpy constants for the padded rescale at `level` (active prefix
    L0-level → L0-level-1), pipeline.py:57; same math as
    parallel/dist.make_dist_rescale."""
    qs = p.qs
    L0 = len(qs)
    active = L0 - level
    assert active >= 2
    qk = qs[active - 1]
    pz = p.zp
    assert pz & (pz - 1) == 0
    keep = np.zeros((L0, 1), dtype=np.uint32)
    sel = np.zeros((L0, 1), dtype=np.uint32)
    sel[active - 1] = 1
    qk_mod = np.zeros((L0, 1), dtype=np.uint32)
    qk_mod_s = np.zeros((L0, 1), dtype=np.uint32)
    inv_qk = np.ones((L0, 1), dtype=np.uint32)
    inv_qk_s = np.zeros((L0, 1), dtype=np.uint32)
    for j, qj in enumerate(qs):
        if j >= active - 1:
            continue
        keep[j] = 1
        qk_mod[j] = qk % qj
        qk_mod_s[j] = shoup_const(qk % qj, qj)
        iv = pow(qk, -1, qj)
        inv_qk[j] = iv
        inv_qk_s[j] = shoup_const(iv, qj)
    return {
        "keep": keep, "sel": sel, "qk_mod": qk_mod, "qk_mod_s": qk_mod_s,
        "inv_qk": inv_qk, "inv_qk_s": inv_qk_s,
        "half": np.uint32(qk // 2).reshape(1),
        "qk_mod_p": np.uint32(qk % pz).reshape(1),
        "inv_qk_p": np.uint32(pow(qk, -1, pz)).reshape(1),
    }


def _on(c: dict, device) -> dict:
    """The constants of `_level_consts` as int64 tensors on device."""
    return {k: torch.from_numpy(np.asarray(v).astype(np.int64)).to(device) for k, v in c.items()}


def rescale_padded(p: FastParams, ct: torch.Tensor, c: dict) -> torch.Tensor:
    """Padded exact rescale (pipeline.py:92): ct int32 [..., L0, n], NTT
    domain with rows ≥ active zeroed; drops row active-1 per the constants
    `c` (`_level_consts`, as numpy arrays or int64 tensors on ct's device),
    keeping the full allocation."""
    if isinstance(next(iter(c.values())), np.ndarray):
        c = _on(c, ct.device)
    q = qcol(p.qs, ct.device)
    pz = p.zp
    mask = pz - 1
    coeff = widen(fast._intt_p(p, ct))                  # [..., L0, n]
    r = (coeff * c["sel"]).sum(dim=-2)                   # the dropped limb's row
    is_neg = r > c["half"]
    r_mod_p = r & mask
    rc_mod_p = torch.where(is_neg, (r_mod_p + pz - (c["qk_mod_p"] & mask)) & mask, r_mod_p)
    tt = (((pz - rc_mod_p) & mask) * c["inv_qk_p"]) & mask
    t_neg = tt > pz // 2
    r_red = r[..., None, :] % q
    qk_mod = c["qk_mod"]
    rc = torch.where(is_neg[..., None, :],
                     torch.where(r_red >= qk_mod, r_red - qk_mod, r_red + q - qk_mod), r_red)
    ttb = tt[..., None, :]
    tc = torch.where(t_neg[..., None, :], q - (pz - ttb), ttb)
    delta = _cond_sub(rc + tc * qk_mod % q, q)
    diff = torch.where(coeff >= delta, coeff - delta, coeff + q - delta)
    out = diff * c["inv_qk"] % q * c["keep"]
    return fast._ntt_p(p, narrow(out))


def make_pipeline_chain(p: FastParams, mesh, hints, mb: int, n_micro: int):
    """Build the pipelined deep chain (pipeline.py:129), called on every
    rank of `mesh`, a DeviceMesh with a 'stage' axis (other axes replicate).

    hints: list over D levels of (hb, ha) PADDED [L0, L0, n] NTT-domain
    uint32 arrays or int32 tensors (rows/targets beyond the level's active
    prefix zeroed);
    each stage uploads only its own k = ⌈D/S⌉ levels. When D % S != 0 the
    level list is padded with DISABLED slots (an enable flag per slot
    passes the ciphertext through). Returns run(cts) mapping an int32
    DTensor [n_micro·mb, 2, L0, n], sharded over 'stage' along its first
    axis, to the stage-sharded [S, n_micro·mb, 2, L0, n] buffers of the
    stages after all D levels: the chain's result is shard S − 1, held by
    the last stage (`out.to_local()[0]` there)."""
    dev = _device(mesh)
    stage = mesh["stage"] if mesh.ndim > 1 else mesh
    S = stage.size()
    s = stage.get_local_rank()
    D = len(hints)
    D_pad = -(-D // S) * S
    k = D_pad // S
    L0 = len(p.qs)
    n = p.n
    M = n_micro
    if M % S:
        raise ValueError(f"n_micro={M} must divide by the stage count {S}")
    M_loc = M // S
    placements = tuple(Shard(0) if name == "stage" else Replicate()
                       for name in mesh.mesh_dim_names)

    mine = range(s * k, (s + 1) * k)                      # this stage's level slots

    def level_hint(lvl, i):
        if lvl >= D:
            return torch.zeros((L0, L0, n), dtype=torch.int32, device=dev)
        h = hints[lvl][i]
        return h.to(dev, torch.int32) if isinstance(h, torch.Tensor) else to_torch(h, dev)

    hb = torch.stack([level_hint(lvl, 0) for lvl in mine])
    ha = torch.stack([level_hint(lvl, 1) for lvl in mine])
    consts = [_on(_level_consts(p, lvl if lvl < D else 0), dev) for lvl in mine]
    enabled = [lvl < D for lvl in mine]

    def run(cts):
        if not isinstance(cts, DTensor) or tuple(cts.placements) != placements:
            raise ValueError(f"cts: want an int32 DTensor with placements {placements}")
        in_buf = cts.to_local().reshape(M_loc, mb, 2, L0, n)
        zeros = torch.zeros((mb, 2, L0, n), dtype=torch.int32, device=dev)
        out_buf = torch.zeros((M, mb, 2, L0, n), dtype=torch.int32, device=dev)
        received = zeros
        for t in range(S + M - 1):
            if t < M:
                # owner-masked injection: the stage holding micro-batch t
                # contributes it, every other stage zeros; one all_reduce
                # moves it to stage 0
                owner = min(t // M_loc, S - 1)
                contrib = in_buf[t - owner * M_loc] if s == owner else zeros
                inj = _all_reduce(contrib, stage, "stage")
            x = (inj if t < M else zeros) if s == 0 else received
            if s <= t < s + M:                              # this stage holds micro-batch t - s
                for j in range(k):
                    if enabled[j]:
                        x = rescale_padded(p, fast.mul_relin(p, x, x, hb[j], ha[j]), consts[j])
            if s == S - 1 and S - 1 <= t < S - 1 + M:
                out_buf[t - (S - 1)] = x
            if S > 1:
                received = _ppermute(x, stage, "stage", [(i, i + 1) for i in range(S - 1)])
        return DTensor.from_local(out_buf.reshape(1, M * mb, 2, L0, n), mesh, placements,
                                  run_check=False)

    run._hint_args = (hb, ha, consts)
    return run
