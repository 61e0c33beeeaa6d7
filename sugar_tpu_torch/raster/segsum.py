"""Segmented column sum of gid-sorted cotangents: the kernel, its plain
version, dispatch.

Port of ``sugar_tpu/raster/segsum.py`` (``segment_sum_sorted`` over the
Pallas kernel ``_kernel``). On CUDA tensors ``segment_sum_sorted``
launches the hand-written Hopper kernel ``csrc/segsum.cu``; on CPU tensors
it runs ``segment_sum_plain``. For a CUDA tensor there is no fallback.

The kernel is instantiated for 1..MAX_ROWS rows. More rows (the Pallas
kernel takes any count) are summed in row blocks of at most MAX_ROWS, one
launch per block into that block's rows of the output: rows are summed
independently, so the blocks' sums are bit-equal to one wide launch's.
"""

from __future__ import annotations

import ctypes

import torch

from sugar_tpu_torch import native
from sugar_tpu_torch.utils import profiling


def segment_sum_plain(ct: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    """(rows, n): out[:, g] = sum of the columns of ``ct`` (rows, D) whose
    ``gid`` (D,) equals g; ids outside [0, n) are dropped. On the CPU,
    ``index_add_`` accumulates column by column in order, so a sorted
    ``gid`` gives each sum in slot order, as the kernel takes it."""
    rows = ct.shape[0]
    valid = (gid >= 0) & (gid < n)
    idx = torch.where(valid, gid, n).to(torch.int64)
    out = torch.zeros((rows, n + 1), dtype=ct.dtype, device=ct.device)
    out.index_add_(1, idx, ct)
    return out[:, :n]


def _kernel_fn():
    fn = native.load("segsum").sugar_segment_sum
    if fn.argtypes is None:
        vp = ctypes.c_void_p
        fn.argtypes = [vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, vp, vp]
        fn.restype = ctypes.c_int
    return fn


MAX_ROWS = 16  # rows per kernel launch; more go in row blocks


def _check(ct: torch.Tensor, gid: torch.Tensor, n: int) -> None:
    if not ct.is_cuda:
        raise ValueError("segment_sum_cuda needs CUDA tensors")
    if gid.device != ct.device:
        raise ValueError(f"gid is on {gid.device}, ct on {ct.device}")
    if ct.dtype != torch.float32 or ct.dim() != 2 or not ct.is_contiguous():
        raise ValueError("ct must be a contiguous 2-D float32 tensor")
    if ct.shape[0] < 1:
        raise ValueError("ct must have 1 or more rows")
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError("gid must be a contiguous 1-D int32 tensor")
    if gid.shape[0] != ct.shape[1]:
        raise ValueError(f"gid has {gid.shape[0]} ids for {ct.shape[1]} columns")
    if not 1 <= n < 2**31:
        raise ValueError(f"n must be in [1, 2^31), got {n}")


def _launch(ct: torch.Tensor, gid: torch.Tensor, n: int, out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel into ``out`` (rows, n), which it overwrites
    entirely, on the current stream: one launch per row block
    (``row_blocks``), each counted."""
    _check(ct, gid, n)
    if out.shape != (ct.shape[0], n) or out.dtype != torch.float32 or not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 ({ct.shape[0]}, {n}) tensor")
    if out.device != ct.device:
        raise ValueError(f"out is on {out.device}, ct on {ct.device}")
    return row_blocks(ct, gid, n, out)


def row_blocks(ct: torch.Tensor, gid: torch.Tensor, n: int, out: torch.Tensor) -> torch.Tensor:
    """Rows r0:r0+MAX_ROWS of ``ct`` into the same rows of ``out``, one
    ``_launch_block`` each (row slices of contiguous arrays are
    contiguous); up to MAX_ROWS rows, one launch of the whole input."""
    if ct.shape[0] <= MAX_ROWS:
        _launch_block(ct, gid, n, out)
        return out
    for r0 in range(0, ct.shape[0], MAX_ROWS):
        _launch_block(ct[r0 : r0 + MAX_ROWS], gid, n, out[r0 : r0 + MAX_ROWS])
    return out


def _launch_block(ct: torch.Tensor, gid: torch.Tensor, n: int, out: torch.Tensor) -> None:
    """One launch of csrc/segsum.cu on checked inputs of at most MAX_ROWS
    rows; counts it."""
    fn = _kernel_fn()
    with torch.cuda.device(ct.device):
        err = fn(
            ct.data_ptr(), gid.data_ptr(), ct.shape[1], ct.shape[0], n, out.data_ptr(),
            torch.cuda.current_stream(ct.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error {err}")
    segment_sum_cuda.launches += 1


def segment_sum_cuda(ct: torch.Tensor, gid: torch.Tensor, n: int) -> torch.Tensor:
    """Launch the Hopper segment-sum kernel on the current stream. ``gid``
    must be ascending (each block finds its columns by searching the
    sorted ids). The kernel writes every output element, so the output is
    allocated uninitialized. Any row count >= 1: MAX_ROWS rows per launch.
    ``segment_sum_cuda.launches`` counts successful launches, one per row
    block."""
    _check(ct, gid, n)
    out = torch.empty((ct.shape[0], n), dtype=torch.float32, device=ct.device)
    return _launch(ct, gid, n, out)


segment_sum_cuda.launches = 0


@profiling.spanned("raster.k3")
def segment_sum_sorted(ct: torch.Tensor, gid_sorted: torch.Tensor, n: int) -> torch.Tensor:
    """Returns (rows, n): out[:, g] = sum of ct columns with gid == g, for
    columns sorted by ascending gid; sentinel ids (>= n) are dropped. CUDA
    tensors go through the kernel, CPU tensors through the plain version."""
    if ct.is_cuda:
        return segment_sum_cuda(ct, gid_sorted, n)
    if ct.device.type == "cpu":
        return segment_sum_plain(ct, gid_sorted, n)
    raise ValueError(f"no segment-sum path for device {ct.device}")
