"""Builds the hand-written CUDA kernels of ``csrc/`` and loads them.

Each ``csrc/<name>.cu`` exposes a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into a shared library under ``_build/``
(listed in .gitignore), named by a hash of its source, the shared headers
(``csrc/*.cuh``) and the flags, and bound with ``ctypes``. Nothing is
built when the package is imported: the first call that needs a kernel
builds it, so the package imports on machines without ``nvcc`` or a GPU.
``build_all`` starts one ``nvcc`` per kernel, all at once, and waits for
them together.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "_build")

KERNELS = ("tile_composite", "tile_composite_bwd", "segsum")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME or put nvcc on PATH)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    for path in [os.path.join(_SRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(_SRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(_BUILD, f"{name}_{h.hexdigest()[:16]}.so")


def build_all(names=KERNELS) -> dict[str, tuple[float, str]]:
    """Compile every kernel of ``names`` that is not built yet, one nvcc
    process each, started together. Returns {name: (seconds, nvcc output)}
    for the kernels it compiled (the output holds ptxas's register and
    shared-memory report). Raises RuntimeError with the compiler's output
    when any build fails."""
    os.makedirs(_BUILD, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        tmp = f"{so}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(_SRC, f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, so)
    done, failed = {}, []
    for name, (proc, tmp, so) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}:\n{log}")
            continue
        os.replace(tmp, so)
        done[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return done


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(_so_path(name))
        _libs[name] = lib
    return lib
