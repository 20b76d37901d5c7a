"""Build the port's native code into shared libraries and load them with ctypes.

Two libraries, each with a plain C interface (no PyTorch headers), so each
builds in seconds:
  * the CUDA kernels: every csrc/*.cu with nvcc (`build`, `library`);
  * the host BVH builder: csrc/host/bvh_sah.cpp with g++ (`build_host`,
    `host_library`).
Each source is compiled to an object by a compiler process of its own, all
started together, and the objects are linked by one more.
Each goes to mcpt_tpu_torch/_build/, named by a hash of its sources and
command line, is published with an atomic rename (several test workers may
build at once), and is reused while neither changes. Nothing is built when
the package is imported: the first kernel launch on a CUDA tensor, or the
first BVH build, builds, and both can be called ahead of time.
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_LINK_FLAGS = ["-shared", "-gencode", "arch=compute_90a,code=sm_90a"]
HOST_SRC = os.path.join(CSRC_DIR, "host", "bvh_sah.cpp")
# No -march=native and no contraction: the builder's output must not depend
# on the host CPU (the source writes its two fused multiply-adds as std::fma).
GXX_FLAGS = ["-O3", "-std=c++17", "-ffp-contract=off", "-fPIC"]
GXX_LINK_FLAGS = ["-shared"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types; every pointer and the stream are
# c_void_p, every one returns cudaGetLastError().
SIGNATURES = {
    "woop_closest": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "woop_any": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "traverse_closest": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "traverse_any": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    "schedule_prepass": [_P] * 3 + [_I] * 6 + [_P] * 4,
    "schedule_closest": [_P] * 10 + [_I] * 5 + [_P] * 5,
    "schedule_any": [_P] * 10 + [_I] * 5 + [_P] * 2,
    "select_closest": [_P] * 10 + [_I] * 7 + [_P] * 5,
    "select_any": [_P] * 10 + [_I] * 7 + [_P] * 2,
}

_lib = None
_host_lib = None
last_build: dict = {}  # seconds, command and compiler output of this process's nvcc build
last_host_build: dict = {}  # the same for the g++ build


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")) + glob.glob(os.path.join(CSRC_DIR, "*.cuh")))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    found = path if os.path.exists(path) else shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and PATH)")
    return found


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands at once; their joined output, or raise on a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{os.path.basename(c[0])} failed ({p.returncode}): {' '.join(c)}\n{o}")
    return "".join(outs)


def _compile(compiler: str, flags: list[str], link_flags: list[str], srcs: list[str],
             inputs: list[str], name: str, info: dict) -> str:
    """Compile `inputs` into _build/<name>_<hash>.so unless built already; the
    hash covers `srcs` and the flags. Each input is compiled to an object by
    a process of its own, all at once, and the objects are linked with
    `link_flags`. Returns the library's path."""
    h = hashlib.sha256(" ".join(flags + link_flags).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(os.path.basename(s).encode() + f.read())
    out = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    t0 = time.perf_counter()
    objs = [f"{tmp}.{os.path.basename(s)}.o" for s in inputs]
    cmds = [[compiler, *flags, "-c", "-o", o, s] for o, s in zip(objs, inputs)]
    try:
        output = _run_all(cmds)
        cmds.append([compiler, *link_flags, "-o", tmp, *objs])
        output += _run_all(cmds[-1:])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    info.update(seconds=time.perf_counter() - t0, cmd="\n".join(" ".join(c) for c in cmds), output=output)
    os.replace(tmp, out)  # atomic: a concurrent builder sees the old name or the whole file
    return out


def build() -> str:
    """Compile every csrc/*.cu, one nvcc process a source, all at once, and
    link them into one .so (if not built yet); return its path."""
    srcs = sources()
    return _compile(_nvcc(), NVCC_FLAGS, NVCC_LINK_FLAGS, srcs, [s for s in srcs if s.endswith(".cu")],
                    "libmcpt_kernels", last_build)


def build_host() -> str:
    """Compile the host BVH builder with g++ (if not built yet); return its path."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH (needed for the host BVH builder)")
    return _compile(gxx, GXX_FLAGS, GXX_LINK_FLAGS, [HOST_SRC], [HOST_SRC], "libmcpt_host", last_host_build)


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


def host_library() -> ctypes.CDLL:
    """The loaded host library, built on first use."""
    global _host_lib
    if _host_lib is None:
        lib = ctypes.CDLL(build_host())
        fn = lib.mcpt_torch_build_bvh
        fn.argtypes = [_P, _P, _P, ctypes.c_int64, ctypes.c_int32, _P, _P, _P, _P, _P, _P]
        fn.restype = ctypes.c_int64
        _host_lib = lib
    return _host_lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
