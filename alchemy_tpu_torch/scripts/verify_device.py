"""CUDA kernel correctness on the card — port of `scripts/verify_device.py`.

`run_checks(device)` runs every kernel of the harness on the card and holds
it bit for bit against its plain PyTorch version on the same inputs (the
plain versions are what the tests hold against the JAX package): A and B
(`fast.mul_relin`, raw and Shoup hints), 4, then 5 (on the dropped rows)
and 7 (`mul_relin_hybrid`, `rescale_joint`), 6 and 5 (`grid_transforms("pallas")`),
all in the "pallas" order at the JAX script's shapes (SHAPES): n = 2^14,
L = 4 and 8, and the bench headline n = 2^15, L = 8, Bt = 16 with Shoup
hints, so that the recorded PASS guards the recorded number. Kernels 8 and
9 ("mxu") are held by `chip_smoke.py`. `alchemy_tpu_torch.bench` embeds the
result as `native_kernel_checks`. On the CPU (`device="cpu"`) every wrapper
runs its plain version, so the checks hold the plain versions against
themselves.

`modq_checks(device)` holds the general path's mod-q kernels
(`backend/cuda/modq.py`) against their plain forms at HomomRLWR's shapes
(MODQ_MATMULS, MODQ_ROWS) and, on the card, times both in a CUDA graph
beside each kernel's bound: the bytes it must move over the H100's 3.35 TB/s.

    python -m alchemy_tpu_torch.scripts.verify_device [--device cpu]

prints the dict, then one `{"modq": [...]}` line, and exits 1 on any failure.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

#: (log2 n, limbs[, ciphertexts]) of the checks, as in the JAX script
SHAPES = {"mul_relin": (14, 4), "hybrid": (14, 8), "headline": (15, 8, 16)}
#: the headline check's key, named after SHAPES["headline"] (a CPU rehearsal
#: at smaller `shapes` keeps it)
HEADLINE_KEY = "headline_n2e15_L8_Bt16_shoup_bitident"
#: HomomRLWR's most frequent contractions, (L, d_out, K, A, B): W [L, 2·d_out, K]
#: against x [L, A, K, B], whose R = A·B columns a call splits both ways
MODQ_MATMULS = ((3, 120, 120, 1, 72), (3, 72, 72, 120, 1), (4, 120, 120, 6, 12),
                (6, 128, 128, 1, 72), (6, 12, 12, 1920, 12))
#: the [L, n] rows HomomRLWR's elementwise methods take most
MODQ_ROWS = ((6, 11520), (4, 8640), (3, 8640))
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory


def _mul_relin_plain(p, ct_a, ct_b, hint_b, hint_a):
    """`fast.mul_relin` through the plain versions of kernels A and B."""
    from alchemy_tpu_torch.backend.cuda import mul_relin as mr

    L, n = len(p.qs), p.n
    c0, c1, c2c = mr.tensor_intt_plain(n, p.qs, ct_a.reshape(-1, 2, L, n),
                                       ct_b.reshape(-1, 2, L, n), p.order)
    return mr.digit_relin_plain(n, p.qs, c0, c1, c2c, hint_b, hint_a, p.order).reshape(ct_a.shape)


def _uniform_rows(rng, qs, n, count, device):
    x = np.stack([np.stack([rng.integers(0, q, n) for q in qs])
                  for _ in range(count)]).astype(np.uint32)
    return torch.from_numpy(x.view(np.int32)).to(device)


def run_checks(device: str = "cuda", shapes: dict = SHAPES) -> dict:
    from alchemy_tpu_torch.backend.cuda import rescale as rk
    from alchemy_tpu_torch.she import fast
    from alchemy_tpu_torch.she.fast import FastParams
    from alchemy_tpu_torch.she.hybrid import (
        HybridKS,
        _rescale_joint_plain,
        hybrid_keygen_hint,
        mul_relin_hybrid,
        mul_relin_hybrid_plain,
        rescale_joint,
    )

    results = {}
    rng = np.random.default_rng(0)

    # 1. kernels A + B against their plain versions (raw, then Shoup hint
    #    pairs), plus the decrypt oracle
    p = FastParams.make(*shapes["mul_relin"], zp=2, impl="pallas")
    s = fast.keygen(p, rng, device=device)
    hb, ha = fast.relin_hint(p, s, rng, shoup=False)
    m1 = rng.integers(0, p.zp, p.n)
    m2 = rng.integers(0, p.zp, p.n)
    ct1 = fast.encrypt(p, s, m1, rng)
    ct2 = fast.encrypt(p, s, m2, rng)
    got = fast.mul_relin(p, ct1, ct2, hb, ha)
    want = _mul_relin_plain(p, ct1, ct2, hb, ha)
    results["mul_relin_bitident"] = bool(torch.equal(got, want))
    hsb = fast.shoup_precompute(hb, p.qs)
    hsa = fast.shoup_precompute(ha, p.qs)
    got_s = fast.mul_relin(p, ct1, ct2, hsb, hsa)
    results["mul_relin_shoup_bitident"] = bool(torch.equal(got_s, want))
    dec = fast.decrypt(p, s, got)
    conv = np.convolve(m1, m2)                      # negacyclic ring product
    ring_prod = conv[:p.n].copy()
    ring_prod[:p.n - 1] -= conv[p.n:]
    results["mul_relin_decrypt"] = bool(np.array_equal(dec, ring_prod % p.zp))

    # 2. hybrid: kernels A + 4 + 5 + 7 against the plain path, raw and Shoup
    p8 = FastParams.make(*shapes["hybrid"], zp=2, impl="pallas")
    hk = HybridKS.make(p8)
    s8, (hhb, hha) = hybrid_keygen_hint(hk, rng, device=device)
    c1 = fast.encrypt(p8, s8, rng.integers(0, 2, p8.n), rng)
    c2 = fast.encrypt(p8, s8, rng.integers(0, 2, p8.n), rng)
    got_h = mul_relin_hybrid(hk, c1, c2, hhb, hha)
    want_h = mul_relin_hybrid_plain(hk, c1, c2, hhb, hha)
    results["hybrid_bitident"] = bool(torch.equal(got_h, want_h))
    hsb_h = fast.shoup_precompute(hhb, hk.pe.qs)
    hsa_h = fast.shoup_precompute(hha, hk.pe.qs)
    got_hs = mul_relin_hybrid(hk, c1, c2, hsb_h, hsa_h)
    results["hybrid_shoup_bitident"] = bool(torch.equal(got_hs, want_h))

    # 3. the joint P-rescale (kernel 5 on the dropped rows alone, then kernel 7,
    #    which takes the kept rows in the NTT domain) against its plain version
    pe = hk.pe
    x = _uniform_rows(rng, pe.qs, pe.n, 2, device)
    got_r = rescale_joint(pe, x, len(hk.ps))
    want_r = _rescale_joint_plain(pe, x, len(hk.ps))
    results["rescale_joint_bitident"] = bool(torch.equal(got_r, want_r))

    # 4. the standalone 3-factor transforms (kernels 6 and 5)
    rows = _uniform_rows(rng, p8.qs, p8.n, 2, device)
    (ntt3, intt3), (ntt3_plain, _) = (rk.grid_transforms("pallas", plain)
                                      for plain in (False, True))
    fwd = ntt3(p8.n, p8.qs, rows)
    back = intt3(p8.n, p8.qs, fwd)
    results["ntt3_grid_bitident"] = bool(torch.equal(fwd, ntt3_plain(p8.n, p8.qs, rows)))
    results["ntt3_grid_roundtrip"] = bool(torch.equal(back, rows))

    # 5. the bench headline: n = 2^15, L = 8, Bt = 16, Shoup hint pairs
    log_n, L, Bt = shapes["headline"]
    p15 = FastParams.make(log_n, L, zp=2, impl="pallas")
    s15 = fast.keygen(p15, rng, device=device)
    hb15, ha15 = fast.relin_hint(p15, s15, rng, shoup=True)
    cta = torch.stack([fast.encrypt(p15, s15, rng.integers(0, 2, p15.n), rng)
                       for _ in range(Bt)])
    ctb = torch.stack([fast.encrypt(p15, s15, rng.integers(0, 2, p15.n), rng)
                       for _ in range(Bt)])
    got16 = fast.mul_relin(p15, cta, ctb, hb15, ha15)
    want16 = _mul_relin_plain(p15, cta, ctb, hb15, ha15)
    results[HEADLINE_KEY] = bool(torch.equal(got16, want16))

    results["pass"] = all(v for k, v in results.items() if k != "pass")
    return results


def modq_cases(rng, device: str) -> list[tuple]:
    """(kernel, shape key as `launch.LAUNCHES_BY_SHAPE` has it, the kernel's
    call, its plain form's call, bytes it must move: each input read once,
    each output written once) of every mod-q kernel at HomomRLWR's shapes."""
    from alchemy_tpu_torch.backend.cuda import modq
    from alchemy_tpu_torch.backend.torch_backend import TorchBackend
    from alchemy_tpu_torch.examples import homomrlwr

    tb, zqs = TorchBackend(device), tuple(homomrlwr.ZQS.qs)

    def rows(qs, *shape):
        return torch.from_numpy(np.stack([rng.integers(0, q, shape) for q in qs])).to(device)

    cases = []
    for L, D, K, A, B in MODQ_MATMULS:
        qs, R = zqs[:L], A * B
        x = rows(qs, A, K, B)
        p = torch.matmul(tb._mat_halves([rng.integers(0, q, (D, K)) for q in qs], qs),
                         modq.split16(x))
        cases += [("gp_split16", (L, K, R), lambda x=x: modq.split16(x),
                   lambda x=x: modq.split16_plain(x), 24 * L * K * R),
                  ("gp_recombine", (L, D, R), lambda p=p, qs=qs, A=A, B=B: modq.recombine(
                      p, qs, A, B), lambda p=p, qs=qs, A=A, B=B: modq.recombine_plain(
                      p, qs, A, B), 40 * L * D * R)]
    for L, n in MODQ_ROWS:
        qs = zqs[:L]
        a, b = (rows(qs, n) for _ in range(2))
        consts, w = tuple(range(3, 3 + L)), 8 * L * n
        cases += [
            ("gp_binop", ("add", L, n), lambda a=a, b=b, qs=qs: modq.binop("add", a, b, qs),
             lambda a=a, b=b, qs=qs: modq.binop_plain("add", a, b, qs), 3 * w),
            ("gp_binop", ("mul", L, n), lambda a=a, b=b, qs=qs: modq.binop("mul", a, b, qs),
             lambda a=a, b=b, qs=qs: modq.binop_plain("mul", a, b, qs), 3 * w),
            ("gp_scale_pad", (L - 1, L, n),
             lambda a=a, qs=qs, c=consts: modq.scale_pad(a, c[:-1], qs[:-1], len(qs)),
             lambda a=a, qs=qs, c=consts: modq.scale_pad_plain(a, c[:-1], qs[:-1], len(qs)),
             w * (2 * L - 1) // L),
            ("gp_rescale_step", (L - 1, n), lambda a=a, qs=qs: modq.rescale_step(a, qs, 16),
             lambda a=a, qs=qs: modq.rescale_step_plain(a, qs, 16), w * (2 * L - 1) // L)]
    return cases


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps launches captured in one
    CUDA graph and replayed (after one warm-up call and one replay): the
    kernels back to back, without the host's time between launches."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    del g
    return start.elapsed_time(end) / reps


def modq_checks(device: str = "cuda", reps: int = 50) -> list[dict]:
    """Each case of `modq_cases`: the kernel bit-identical to its plain
    form; on the card the device ms of both in a CUDA graph (`graph_ms`,
    `plain_ms`) and the bound (`bound_ms`, bytes at 3.35 TB/s)."""
    out = []
    for kernel, key, fn, plain, nbytes in modq_cases(np.random.default_rng(1), device):
        r = {"kernel": kernel, "shape": list(key), "bitident": bool(torch.equal(fn(), plain())),
             "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if device != "cpu":
            r["graph_ms"], r["plain_ms"] = graph_ms(fn, reps), graph_ms(plain, reps)
        out.append(r)
    return out


def main(device: str | None = None, argv=None) -> int:
    from alchemy_tpu_torch.bench import run_args

    device = run_args("alchemy_tpu_torch.scripts.verify_device", device, argv).device
    res = run_checks(device)
    print(json.dumps(res, indent=1))
    modq = modq_checks(device)
    print(json.dumps({"modq": modq}))
    return 0 if res["pass"] and all(r["bitident"] for r in modq) else 1


if __name__ == "__main__":
    sys.exit(main(argv=sys.argv[1:]))
