"""Tiny configurations and traffic for the benchmark's CPU tests, and the
fixture that skips a test that needs the card."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch


def tiny_config(key_switching: str) -> dict:
    """A configuration of the benchmark's kind at n = 2^10 (L = 3 for
    TrivGad; L = 5 in uneven groups 3 + 2 with K = 3 for hybrid), with
    moduli as the port's parameter makers choose them."""
    from alchemy_tpu_torch.she import fast, hybrid

    if key_switching == "trivgad":
        p = fast.FastParams.make(10, 3)
        extra = {"shoup_hints": True}
    else:
        p = fast.FastParams.make(10, 5)
        hk = hybrid.HybridKS.make(p, dnum=2)
        extra = {"dnum": hk.dnum, "special_primes": list(hk.ps), "shoup_hints": False}
    return {"name": f"tiny_{key_switching}", "system": "bgv_mul_relin", "n": p.n,
            "qs": list(p.qs), "zp": 2, "order": "mxu", "key_switching": key_switching,
            "variance": 10.24, "limits": {"mismatch": 0, "bad_slots": 0}, **extra}


def tiny_traffic(batch: int) -> dict:
    """Closed loop, one caller, `batch` pairs a call; a synchronize after
    each call when batch is 1, as the benchmark's single traffic."""
    return {"loop": "closed", "callers": 1, "batch": batch, "sync_each_call": batch == 1,
            "pool_min_bytes": 0, "warmup_calls": 1, "kept_calls": 2, "trace_calls": 2,
            "end_to_end": ["call_p95_ms"] if batch == 1 else ["ct_mul_per_s"]}


@pytest.fixture
def tiny():
    """The tiny configuration and traffic makers."""
    return SimpleNamespace(config=tiny_config, traffic=tiny_traffic)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"
