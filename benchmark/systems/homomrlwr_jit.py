"""The system under test of configurations with "system": "homomrlwr_jit":
ALCHEMY's HomomRLWR on the port's general path. Its ring-rounding program
(`examples.homomrlwr.ring_round`: five ring tunnels H0 → H5 at Z_32, then the
depth-5 rescale tree down to Z_2) is compiled by `interp.pt2ct.pt2ct`
against a `KeysHints` context on the card and prepared by
`interp.jit_exec.jit_compile` as one CUDA graph; a call is one replay.

Set-up checks the configuration against the port (the towers, the moduli,
the five maps against `examples.common.dec_to_crt`), puts one key a
ciphertext ring, drawn from that ring's own stream of the seed, into the
context before compiling (so that the reference can draw the output ring's
key again), compiles (hints and encryptions draw from the context's
generator, the seed's HINT stream), encrypts s once and fills a pool of
arguments mulPublic(a_k, enc s) holding at least traffic["pool_min_bytes"];
call k runs the program on slot k mod slots. On the card set-up ends with
`SETTLE_S` seconds of calls back to back: in the first 0–20 s after set-up
a replay takes ~15.4 ms on the card, then ~13.3 ms for the rest of the
process, at the same clocks, whether the card worked or idled meanwhile (a
state of the machine after set-up, not of the program); a server runs in
the second. `judge` decrypts each kept output with `reference_rlwr` and
counts the Z_2 coefficients that differ from the reference's
ringRound(s·a_slot).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from alchemy_tpu_torch.backend import golden_backend
from alchemy_tpu_torch.backend.torch_backend import TorchBackend
from alchemy_tpu_torch.core.cyc import Cyc
from alchemy_tpu_torch.examples import common, homomrlwr
from alchemy_tpu_torch.interp.jit_exec import jit_compile
from alchemy_tpu_torch.interp.keys_hints import KeysHints
from alchemy_tpu_torch.interp.pt2ct import pt2ct
from alchemy_tpu_torch.she import bgv
from alchemy_tpu_torch.she.gadget import TrivGad
from alchemy_tpu_torch.she.keys import SK
from benchmark import inputs, reference_rlwr

#: seconds of calls that end set-up on the card
SETTLE_S = 25.0


def check(cfg: dict) -> None:
    """Raise where the configuration differs from the port's HomomRLWR: its
    towers, moduli, plaintext moduli, tree depth and gadget, and each map's
    (e, r, s, images) against `dec_to_crt`."""
    port = {"tower": common.TOWER, "tower_ct": common.TOWER_P, "qs": list(homomrlwr.ZQS.qs),
            "zp_in": homomrlwr.ZP_IN, "zp_out": homomrlwr.ZP_OUT, "tree_depth": homomrlwr.K,
            "gadget": "TrivGad"}
    for k, v in port.items():
        if cfg[k] != v:
            raise ValueError(f"{k}: the configuration gives {cfg[k]}, the port {v}")
    if len(cfg["maps"]) != len(cfg["tower"]) - 1:
        raise ValueError(f"{len(cfg['maps'])} maps for a tower of {len(cfg['tower'])} rings")
    gb = golden_backend()
    for hop, r, s in zip(cfg["maps"], cfg["tower"], cfg["tower"][1:]):
        f = common.dec_to_crt(r, s, cfg["zp_in"], gb)
        want = {"e": f.e, "r": f.r, "s": f.s,
                "images": [gb.to_numpy(y.to_pow().data)[0].tolist() for y in f.images]}
        if hop != want:
            raise ValueError(f"map {r} -> {s}: the configuration's differs from dec_to_crt's")


def pool_slots(cfg: dict, traffic: dict) -> int:
    """Slots of the pool: one argument ciphertext each, two components of
    arg_limbs int64 rows of φ(tower_ct[0]), together at least
    traffic["pool_min_bytes"]."""
    per_slot = 2 * cfg["arg_limbs"] * reference_rlwr.Ring(cfg["tower_ct"][0]).phi * 8
    return max(2, math.ceil(traffic["pool_min_bytes"] / per_slot))


class System:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device):
        t0 = time.perf_counter()
        check(cfg)
        bk = TorchBackend(device)
        ctx = KeysHints(cfg["variance_param"], bk=bk)
        ctx.rng = inputs.stream(seed, inputs.HINT)
        for m in cfg["tower_ct"]:
            ctx.keys[m] = SK.generate(m, ctx.svar(m), inputs.stream(seed, inputs.KEY, m))
        m0, zp = cfg["tower"][0], cfg["zp_in"]
        compiled = pt2ct(homomrlwr.ring_round(bk), res_ty=homomrlwr.PT, m_map=common.M_MAP,
                         zqs=homomrlwr.ZQS, gad=TrivGad(), ctx=ctx)
        if len(compiled.arg_qs(0)) != cfg["arg_limbs"]:
            raise ValueError(f"arg_limbs: the configuration gives {cfg['arg_limbs']}, pt2ct "
                             f"{len(compiled.arg_qs(0))}")
        t_compiled = time.perf_counter()
        enc_s = compiled.encrypt_arg(
            Cyc.from_coeffs(m0, (zp,), reference_rlwr.secret(cfg, seed), bk), 0)
        self.slots = pool_slots(cfg, traffic)
        self.pool = [bgv.mul_public(Cyc.from_coeffs(m0, (zp,), reference_rlwr.public(cfg, seed, k),
                                                    bk), enc_s)
                     for k in range(self.slots)]
        t_pool = time.perf_counter()
        self.program = jit_compile(compiled, self.pool[:1])
        t_jit = time.perf_counter()
        settled = 0
        while device.type == "cuda" and time.perf_counter() < t_jit + SETTLE_S:
            self.call(settled)
            torch.cuda.synchronize(device)
            settled += 1
        print(f"[setup] keys, hints and compile {t_compiled - t0:.3f} s, pool of {self.slots} "
              f"arguments {t_pool - t_compiled:.3f} s, jit_compile {t_jit - t_pool:.3f} s, "
              f"{settled} calls to settle {time.perf_counter() - t_jit:.3f} s; bytes "
              f"{self.program.arg_bytes()}", file=sys.stderr, flush=True)

    def call(self, k: int):
        """The timed call: one evaluation on the argument in slot k mod
        slots, a CT at H5' with fresh tensors."""
        return self.program(self.pool[k % self.slots])

    def close(self) -> None:
        """Free the program's state: the prepared program, its hints and the
        pool."""
        del self.program, self.pool


def judge(cfg: dict, traffic: dict, seed: int, kept: dict, device) -> dict:
    """Decrypt the outputs the window kept ({call index: CT at H5'}) with the
    reference under the output ring's key drawn again from the seed, and
    compare each with the reference's ringRound(s·a) of its slot:
    `bad_slots`, the Z_2 coefficients that differ, summed over the calls,
    and the count of calls compared."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    big, small = reference_rlwr.Ring(cfg["tower_ct"][-1]), reference_rlwr.Ring(cfg["tower"][-1])
    slots = pool_slots(cfg, traffic)
    order = sorted(kept)
    s = torch.from_numpy(reference_rlwr.secret(cfg, seed)).to(device)
    a = torch.from_numpy(np.stack([reference_rlwr.public(cfg, seed, k % slots)
                                   for k in order])).to(device)
    want = reference_rlwr.ring_round(cfg, s, a) if order else None
    key = reference_rlwr.key(cfg, seed, big.m)
    bad = 0
    for i, k in enumerate(order):
        out = kept[k]
        if (out.m, out.m_prime, out.zp) != (small.m, big.m, cfg["zp_out"]) or any(
                c.basis != "POW" for c in out.comps):
            raise ValueError(f"call {k}: an output {out} with bases "
                             f"{[c.basis for c in out.comps]}; the judge reads H5' in POW")
        ct = torch.stack([c.data for c in out.comps]).to(device=device, dtype=torch.int64)
        got = reference_rlwr.decrypt(big, small, ct, out.qs, key, out.zp, out.scale)
        bad += int((got != want[i]).sum())
    return {"bad_slots": bad, "compared_calls": len(kept)}
