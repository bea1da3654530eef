"""Build and load the CUDA kernels of `csrc/` (nvcc → shared library → ctypes).

The sources have a plain C interface and include no PyTorch header, so nvcc
builds them in seconds: one nvcc process per source, all started together,
then one link. The library goes to `build/kernels/` at the root of the
checkout, named by a hash of the sources and flags, and is built at first
use; nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("mul_relin.cu", "rescale.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path() -> Path:
    """Path of the built library (building it if it is missing)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    so = BUILD_DIR / f"zq_kernels_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src}.o" for src in SOURCES]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(SOURCES, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = None
    if all(proc.returncode == 0 for proc in procs):
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
    so.with_suffix(".log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link is None or link.returncode != 0:
        raise RuntimeError("nvcc failed:\n" + "".join(logs))
    os.replace(tmp, so)     # atomic: concurrent builders never see half a file
    return so


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, with every entry point's signature set."""
    lib = ctypes.CDLL(str(library_path()))
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.tensor_intt.argtypes = [P] * 8 + [I] * 3 + [P]
    lib.tensor_intt.restype = I
    lib.digit_relin.argtypes = [P] * 11 + [I] * 4 + [P]
    lib.digit_relin.restype = I
    lib.hybrid_digit_relin.argtypes = [P] * 10 + [I] * 7 + [P]
    lib.hybrid_digit_relin.restype = I
    for name in ("intt_grid", "ntt_grid"):
        getattr(lib, name).argtypes = [P] * 5 + [I] * 3 + [P]
        getattr(lib, name).restype = I
    lib.rescale_fwd.argtypes = [P] * 10 + [I] * 5 + [P]
    lib.rescale_fwd.restype = I
    lib.zq_error_string.argtypes = [I]
    lib.zq_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = library().zq_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
