"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by nvcc for Hopper (`sm_90a`) into one
shared library with a plain C interface, loaded with ctypes.  The build runs
at first use and is keyed by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is loaded from
`build/sep2023_tpu_torch/` at the repository root.  A process resolves and
loads the library once; later calls of `load` return it without hashing the
sources again.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sep2023_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIB: ctypes.CDLL | None = None  # the library this process loaded


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (on PATH or under /usr/local/cuda)")
    return nvcc


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsep2023_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every
    exported function's argument and return types declared."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.elastic_forward.argtypes = [P] * 9 + [I] * 8 + [F, F, P]
        lib.elastic_forward.restype = I
        lib.elastic_error_string.argtypes = [I]
        lib.elastic_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
