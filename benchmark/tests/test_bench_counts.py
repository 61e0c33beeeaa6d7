"""benchmark/counts.py and the reference's least-work count on a scene
checked by hand."""

import torch

from benchmark import counts
from benchmark.frozen import PEAK_BYTES_PER_S, PEAK_FP32_PER_S
from benchmark.reference import raster as rr


def stacked_scene():
    """One 16x16 tile. Twenty wide Gaussians of opacity 0.5 cover it, one
    behind the other: a pixel's transmittance after k of them is about
    0.5^k, >= 1e-4 up to k = 13, so the 14th is the one at which every
    pixel stops: 14 evaluated, 13 included. Behind them sits a Gaussian
    that no pixel reaches; one of opacity 0.001 (alpha < 1/255 everywhere)
    lies in front, inside the rect but with no support."""
    v = rr.look_at_view((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 1.0, 16, 16)
    n = 22
    means = torch.zeros(n, 3)
    means[:, 2] = torch.arange(n, dtype=torch.float32) * 0.01 + 2.0
    means[0, 2] = 1.5
    scales = torch.full((n, 3), 50.0)
    q = torch.zeros(n, 4)
    q[:, 0] = 1
    op = torch.full((n,), 0.5)
    op[0] = 0.001
    col = torch.rand(n, 3)
    sc = rr.project(means, rr.cov_from_quaternions(scales, q), op, v, colors=col)
    return sc, v


def test_least_work_counts_by_hand():
    sc, v = stacked_scene()
    c = dict(pixels=256)
    rr.render(sc, v, torch.zeros(3), c)
    assert c["k1_pairs"] == 256 * 14
    assert c["k3_slots"] == 14
    assert int(c["touched"].sum()) == 14
    assert c["covered"] == 256
    assert counts.frame_use([c, c]) == dict(covered_share=1.0, k1_pairs_per_pixel=14.0)
    ch = 3
    assert counts.k1_ops(c, ch) == 256 * 14 * (23 + 2 * ch)
    assert counts.k2_ops(c, ch) == 256 * 14 * (56 + 4 * ch)
    k1 = max(256 * 14 * 29 / PEAK_FP32_PER_S, (14 * 9 * 4 + 256 * 5 * 4) / PEAK_BYTES_PER_S)
    assert abs(counts.k1_least_s(c, ch) - k1) < 1e-18
    k3 = max(14 * 9 / PEAK_FP32_PER_S, (14 * 10 * 4 + 14 * 9 * 4) / PEAK_BYTES_PER_S)
    assert abs(counts.k3_least_s(c, ch) - k3) < 1e-18


def test_pixels_outside_the_image_are_not_counted():
    """A 16x12 image: its one tile has 64 pixels past the edge."""
    v = rr.look_at_view((0.0, 0.0, 0.0), (0.0, 0.0, 1.0), (0.0, 1.0, 0.0), 1.0, 16, 12)
    means = torch.tensor([[0.0, 0.0, 2.0]] * 3)
    scales = torch.full((3, 3), 50.0)
    q = torch.tensor([[1.0, 0, 0, 0]] * 3)
    sc = rr.project(means, rr.cov_from_quaternions(scales, q), torch.full((3,), 0.5), v,
                    colors=torch.rand(3, 3))
    c = dict(pixels=16 * 12)
    rr.render(sc, v, torch.zeros(3), c)
    assert c["k1_pairs"] == 16 * 12 * 3
    assert c["covered"] == 16 * 12
