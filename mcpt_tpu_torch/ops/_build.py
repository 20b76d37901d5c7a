"""Build csrc/*.cu with one nvcc call into a shared library, load it with ctypes.

The library has a plain C interface (no PyTorch headers), so the build
takes seconds. It goes to mcpt_tpu_torch/_build/, named by a hash of the
sources and the command line, and is reused while neither changes. Nothing
is built when the package is imported: the first kernel launch on a CUDA
tensor builds, and `build()` can be called ahead of time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types; every pointer and the stream are
# c_void_p, every one returns cudaGetLastError().
SIGNATURES = {
    "woop_closest": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P],
    "woop_any": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
}

_lib = None
last_build: dict = {}  # seconds, command and compiler output of this process's build


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def build() -> str:
    """Compile every csrc/*.cu into one .so (if not built yet); return its path."""
    srcs = sources()
    cu = [s for s in srcs if s.endswith(".cu")]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"libmcpt_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build.update(seconds=time.perf_counter() - t0, cmd=" ".join(cmd),
                      output=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
