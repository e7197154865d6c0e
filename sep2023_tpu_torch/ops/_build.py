"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` source is compiled by its own nvcc process for Hopper
(`sm_90a`), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ctypes.  The build runs
at first use and is keyed by a hash of the sources (`*.cu`, `*.cuh`) and
flags, so an edited source rebuilds and an unchanged one is loaded from
`build/sep2023_tpu_torch/` at the repository root.  nvcc's report of each
kernel's registers and spills (`-Xptxas -v`) is kept beside the library
(`build_log`).  A process resolves and loads the library once, under a
lock, so that shard threads reaching first use together run one build; later
calls of `load` return it without hashing the sources again.  Nothing here
runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "sep2023_tpu_torch"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None  # the library this process loaded
_LOAD_LOCK = threading.Lock()


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
    for src in sorted([*_sources(), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsep2023_tpu_torch_{h.hexdigest()[:16]}.so"


def build_log(lib: Path) -> Path:
    """nvcc's output (registers and spills per kernel) for library `lib`."""
    return lib.with_suffix(".log")


def build() -> Path:
    """Compile the sources unless a library for them exists; returns its
    path.  Raises RuntimeError with nvcc's output when the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, failed = [], None
    for cmd, _, proc in jobs:
        text, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0 and failed is None:
            failed = f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{text}"
    try:
        if failed:
            raise RuntimeError(failed)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}): "
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        build_log(out).write_text("\n".join(log))
        os.replace(tmp, out)  # atomic: a concurrent build never sees half
    finally:
        for _, obj, _ in jobs:
            obj.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, with every
    exported function's argument and return types declared."""
    with _LOAD_LOCK:
        if _LIB is None:
            _load_library()
    return _LIB


def _load_library():
    """Load the library of the current sources, built first if needed, and
    declare its functions' argument and return types."""
    global _LIB
    lib = ctypes.CDLL(str(build()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.elastic_forward.argtypes = [P] * 17 + [I] * 17 + [F] * 4 + [P]
    lib.elastic_forward.restype = I
    lib.elastic_backward.argtypes = [P] * 23 + [I] * 16 + [F, F, P]
    lib.elastic_backward.restype = I
    lib.elastic_tile_plan.argtypes = [P]
    lib.elastic_tile_plan.restype = None
    lib.elastic_illumination.argtypes = [P] * 10 + [I] * 8 + [F, F, P]
    lib.elastic_illumination.restype = I
    lib.acoustic_forward.argtypes = [P] * 14 + [I] * 15 + [F, F, P]
    lib.acoustic_forward.restype = I
    lib.acoustic_backward.argtypes = [P] * 23 + [I] * 15 + [F, F, P]
    lib.acoustic_backward.restype = I
    lib.elastic_sum_shots.argtypes = [P, P, I, I, I, P]
    lib.elastic_sum_shots.restype = I
    lib.acoustic_sum_shots.argtypes = [P, P, I, I, I, I, P]
    lib.acoustic_sum_shots.restype = I
    lib.empty_launch.argtypes = [I, P]
    lib.empty_launch.restype = I
    for name in ("elastic_forward_plan", "elastic_backward_plan",
                 "acoustic_forward_plan", "acoustic_backward_plan"):
        getattr(lib, name).argtypes = [P]
        getattr(lib, name).restype = I
    lib.elastic_error_string.argtypes = [I]
    lib.elastic_error_string.restype = ctypes.c_char_p
    _LIB = lib
