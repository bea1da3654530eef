"""ctypes bindings for the native C++ Zq/NTT kernel library — a copy of
`alchemy_tpu/native/__init__.py`, built where the port builds its CUDA
kernels.

`zq_kernels.cpp` is the JAX package's source, unchanged: an oracle written
in neither framework. `ntt`/`intt` are the radix-2 negacyclic transforms of
`backend/ntt.py` (the "vpu" slot order) and `mul_relin` is `she/fast.py`'s
fused multiply + CRT-gadget relinearization at impl="vpu", bit for bit, so
the card's vpu-order kernels can be held against it at full width with no
numpy or torch reference involved.

The library is compiled with g++ at first use into `build/native/` at the
root of the checkout (never into a package directory), named by a hash of
the source and flags; nothing is built when the module is imported, and a
failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "zq_kernels.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC")


def library_path() -> Path:
    """Path of the built library (building it if it is missing)."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    so = BUILD_DIR / f"zq_native_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        run = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SRC)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if run.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"g++ failed to build {SRC.name}:\n{run.stdout}")
        tmp.replace(so)
    return so


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(library_path()))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.zq_add.argtypes = [u32p, u32p, u32p, ctypes.c_uint64, ctypes.c_uint32]
    lib.zq_sub.argtypes = [u32p, u32p, u32p, ctypes.c_uint64, ctypes.c_uint32]
    lib.zq_mul.argtypes = [u32p, u32p, u32p, ctypes.c_uint64, ctypes.c_uint32]
    lib.ntt_negacyclic.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    lib.intt_negacyclic.argtypes = [u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
    lib.bgv_mul_relin.argtypes = [u32p, u32p, u32p, u32p, u32p,
                                  ctypes.c_uint64, ctypes.c_uint64, u32p, u32p]
    return lib


def _p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _c(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint32))


def zq_elemwise(op: str, a, b, q: int) -> np.ndarray:
    a, b = _c(a), _c(b)
    out = np.empty_like(a)
    getattr(_lib(), f"zq_{op}")(_p(a), _p(b), _p(out), a.size, q)
    return out


def ntt(x, q: int, psi: int) -> np.ndarray:
    """Forward negacyclic NTT (bit-identical to backend/ntt.py)."""
    x = _c(x).copy()
    _lib().ntt_negacyclic(_p(x), x.size, q, psi)
    return x


def intt(x, q: int, psi: int) -> np.ndarray:
    x = _c(x).copy()
    _lib().intt_negacyclic(_p(x), x.size, q, psi)
    return x


def mul_relin(ct_a, ct_b, hb, ha, qs, psis) -> np.ndarray:
    """Native fused mul+relin: ct [2, L, n], hints [L, L, n] (NTT domain;
    bit-identical to she/fast.py with impl='vpu')."""
    ct_a, ct_b, hb, ha = map(_c, (ct_a, ct_b, hb, ha))
    two, L, n = ct_a.shape
    out = np.zeros_like(ct_a)
    qs_a = _c(np.asarray(qs))
    psis_a = _c(np.asarray(psis))
    _lib().bgv_mul_relin(_p(ct_a), _p(ct_b), _p(hb), _p(ha), _p(out),
                         L, n, _p(qs_a), _p(psis_a))
    return out
