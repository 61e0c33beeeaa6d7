"""Builds the hand-written CUDA kernels of ``csrc/`` and the host C++
library beside them, and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
(listed in .gitignore), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, and bound with ``ctypes``. Nothing is
built when the package is imported: the first call that needs a kernel
builds it, so the package imports on machines without ``nvcc`` or a GPU.
``build_all`` starts one ``nvcc`` per kernel, all at once, and waits for
them together.

``csrc/qem.cpp`` (quadric mesh decimation, a copy of the JAX package's)
is host code, not a kernel: it is one of ``HOST_LIBS``, which the same
``build_all`` compiles with the host C++ compiler (``CXX``, g++) instead of
``nvcc``, and ``qem_decimate`` loads it at first use. A failed build
raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

KERNELS = ("tile_composite", "tile_composite_bwd", "segsum", "binning", "preprocess")
HOST_LIBS = ("qem",)  # csrc/<name>.cpp, compiled with CXX: host code, not kernels

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _recipe(name: str) -> tuple[list[str], tuple[str, ...]]:
    """(source files, the first the one compiled; flags) of library
    ``name``: a host library is its .cpp with CXX, a kernel its .cu and the
    shared headers with nvcc."""
    if name in HOST_LIBS:
        return [os.path.join(_SRC, f"{name}.cpp")], (CXX, *CXX_FLAGS)
    headers = sorted(glob.glob(os.path.join(_SRC, "*.cuh")))
    return [os.path.join(_SRC, f"{name}.cu")] + headers, NVCC_FLAGS


def _so_path(name: str) -> str:
    sources, flags = _recipe(name)
    h = hashlib.sha256()
    for path in sources:
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return os.path.join(_BUILD, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every library of ``names`` that is not built yet, one
    compiler process each, started together. Returns {name: (seconds,
    compiler output)} for the libraries it compiled (nvcc's output holds
    ptxas's register and shared-memory report). Raises RuntimeError with
    the compiler's output when any build fails (OSError when the compiler
    is missing)."""
    os.makedirs(_BUILD, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        sources, flags = _recipe(name)
        compiler = list(flags) if name in HOST_LIBS else [_nvcc(), *flags]  # CXX leads its flags
        cmd = [*compiler, "-o", tmp, sources[0]]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    done, failed = {}, []
    for name, (proc, tmp, so) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(proc.args[0])} failed for {name}:\n{log}")
            continue
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The library ``name`` (a kernel or a host library), built on first
    use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_so_path(name))
        _libs[name] = lib
    return lib


def _load_qem() -> ctypes.CDLL:
    lib = load("qem")
    if lib.qem_decimate.argtypes is None:
        lib.qem_decimate.restype = ctypes.c_int
        lib.qem_decimate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
    return lib


def qem_available() -> bool:
    """True when the host QEM library builds and loads (the JAX package's
    ``sugar_tpu.native.qem_available``)."""
    try:
        _load_qem()
    except (RuntimeError, OSError):
        return False
    return True


def qem_decimate(
    vertices: np.ndarray, faces: np.ndarray, target_vertices: int
) -> tuple[np.ndarray, np.ndarray]:
    """Garland-Heckbert quadric decimation to ~target_vertices (the JAX
    package's ``sugar_tpu.native.qem_decimate``); the library is built on
    first use."""
    lib = _load_qem()
    v = np.ascontiguousarray(vertices, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv = ctypes.c_int64(0)
    nf = ctypes.c_int64(0)
    rc = lib.qem_decimate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), v.shape[0],
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), f.shape[0],
        int(target_vertices),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(nv),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(nf),
    )
    if rc != 0:
        raise RuntimeError(f"qem_decimate failed with code {rc}")
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()
