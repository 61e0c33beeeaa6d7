"""The least work a frame needs, from the reference's own counts on the
benchmark's inputs; never from the program's outputs or counters.

The reference counts, while it composites a view (``reference/raster.py``):

- ``k1_pairs``: (pixel, Gaussian) pairs that the pixel needs: Gaussians of
  its tile, in depth order, whose alpha >= 1/255 support reaches a pixel
  of the tile, up to and including the one at which the pixel stops;
  pixels inside the image only;
- ``k3_slots``: (tile, Gaussian) pairs with such support that at least one
  pixel of the tile reaches;
- ``touched``: the Gaussians of those pairs;
- ``visible``: the Gaussians inside the view with a non-empty tile rect;
- ``covered``: pixels inside the image that some Gaussian's alpha reaches.

A kernel's least time is the larger of its operations over the fp32 peak
and its bytes over the HBM peak; each input byte counts once as read and
each output byte once as written. No honest kernel reads above 100% of
it: a kernel that does less work is credited through its time.
"""

from __future__ import annotations

from benchmark.frozen import PEAK_BYTES_PER_S, PEAK_FP32_PER_S, ops_per_eval, ops_per_eval_bwd

F32 = 4


def _least(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32_PER_S, nbytes / PEAK_BYTES_PER_S)


def _touched(c: dict) -> int:
    t = c["touched"]
    return int(t.sum()) if hasattr(t, "sum") else int(t)


def k1_ops(c: dict, ch: int) -> int:
    return c["k1_pairs"] * ops_per_eval(ch)


def k2_ops(c: dict, ch: int) -> int:
    return c["k1_pairs"] * ops_per_eval_bwd(ch)


def k1_least_s(c: dict, ch: int) -> float:
    """Forward compositing: reads each needed Gaussian's row (mean 2, conic
    3, opacity 1, colour ch) once, writes the image, final T and the
    contributor count of each pixel."""
    nbytes = _touched(c) * (6 + ch) * F32 + c["pixels"] * (ch + 2) * F32
    return _least(k1_ops(c, ch), nbytes)


def k2_least_s(c: dict, ch: int) -> float:
    """Backward compositing: reads the rows, the image cotangent and final
    T, writes one gradient row per needed Gaussian."""
    nbytes = 2 * _touched(c) * (6 + ch) * F32 + c["pixels"] * (ch + 1) * F32
    return _least(k2_ops(c, ch), nbytes)


def k3_least_s(c: dict, ch: int) -> float:
    """Gradient segment sum: reads each needed (tile, Gaussian) slot's
    gradient row and id once, writes one row per needed Gaussian; one add
    per slot and row."""
    rows = 6 + ch
    nbytes = c["k3_slots"] * (rows + 1) * F32 + _touched(c) * rows * F32
    return _least(c["k3_slots"] * rows, nbytes)


def frame_use(cnts: list) -> dict:
    """How much of the frames the counted views fill: the share of their
    pixels that some Gaussian reaches, and needed K1 pairs per pixel."""
    px = sum(c["pixels"] for c in cnts)
    return dict(covered_share=sum(c["covered"] for c in cnts) / px,
                k1_pairs_per_pixel=sum(c["k1_pairs"] for c in cnts) / px)


def loss_ops(pixels: int, ch: int) -> int:
    """L1 + D-SSIM per pixel and channel: five blurred maps of two 11-tap
    passes (2 ops a tap: 220), the SSIM map (~20), L1 and the clip (~4):
    244 forward, twice that backward."""
    return 732 * pixels * ch
