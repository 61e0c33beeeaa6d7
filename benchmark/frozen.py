"""Pieces copied from the port, frozen here so that a later change to the
program cannot move the yardstick. Each names the place it was copied
from; none is imported from there.

- The blob geometry (``fibonacci_sphere``, ``blob_surface``,
  ``blob_colors``): ``sugar_tpu_torch/eval/parity.py`` ``_fibonacci_sphere``,
  ``blob_surface``, ``blob_colors``, rewritten in torch so that a scene is
  made on the device.
- The trained-statistics scene (``scene_trained``):
  ``sugar_tpu_torch/scripts/bench.py`` ``_scene_trained``, rewritten to
  draw on the device from a ``torch.Generator``.
- The operation counts per (pixel, slot) (``ops_per_eval``,
  ``ops_per_eval_bwd``) and the H100 peaks: ``chip_smoke.py``
  ``_ops_per_eval``, ``_ops_per_eval_bwd``, ``PEAK_FP32_PER_S``,
  ``PEAK_BYTES_PER_S``.
- ``kernel_name``: ``chip_smoke.py`` ``kernel_name``.
- ``card_line``, ``require_cuda``: ``sugar_tpu_torch/utils/profiling.py``.
"""

from __future__ import annotations

import math
import subprocess

import torch

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s and fp32
# operations/s outside the tensor cores. From chip_smoke.py.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def ops_per_eval(ch: int) -> int:
    """fp32 operations of one alpha evaluation in the compositing forward:
    offsets (2), the conic quadratic (9), the power gate (2), exp (1),
    opacity scale and clamp (2), cutoff gate (2), the running product (2),
    the include test (1), and the weighted color sum (2 + 2 per channel).
    From chip_smoke.py ``_ops_per_eval``."""
    return 23 + 2 * ch


def ops_per_eval_bwd(ch: int) -> int:
    """fp32 operations the compositing backward needs per (pixel, slot),
    counted once: the alpha evaluation (18: offsets 2, quadratic 9, power
    gate 2, exp 1, opacity and clamp 2, cutoff gate 2), the running product
    and include test (3), w (1), c . g (2 per channel), the suffix (w (c .
    g), running sum, total minus it, plus the carry: 4), dL/dalpha (max,
    divide, multiply, subtract, select: 5), dpower (2), the mean2d terms
    (8), the conic terms (8), the opacity term (1), the color terms (1 per
    channel), and one add per gradient row to sum the 256 pixels (6 + 1 per
    channel). From chip_smoke.py ``_ops_per_eval_bwd``."""
    return 56 + 4 * ch


def kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, namespaces of
    anonymous scope and argument list. From chip_smoke.py."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def require_cuda(tool: str) -> None:
    """Raise unless a CUDA card is present: a measurement never falls back
    to the CPU. From sugar_tpu_torch/utils/profiling.py."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{tool} measures the CUDA card; torch.cuda.is_available() is False")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` prints them (first card).
    From sugar_tpu_torch/utils/profiling.py."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def fibonacci_sphere(n: int, device) -> torch.Tensor:
    """(n, 3) float64 unit directions, near-uniform (spiral) coverage."""
    i = torch.arange(n, dtype=torch.float64, device=device) + 0.5
    phi = torch.arccos(1 - 2 * i / n)
    theta = math.pi * (1 + 5**0.5) * i
    return torch.stack(
        [torch.sin(phi) * torch.cos(theta), torch.cos(phi), torch.sin(phi) * torch.sin(theta)], -1
    )


def blob_surface(d: torch.Tensor) -> torch.Tensor:
    """Star-shaped radius field r(direction): smooth bumpy blob."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    return (
        0.72
        + 0.11 * torch.sin(3.0 * x + 1.0) * torch.sin(2.0 * y)
        + 0.07 * torch.cos(4.0 * z)
        + 0.05 * torch.sin(5.0 * y + 2.0)
    )


def blob_colors(p: torch.Tensor) -> torch.Tensor:
    c = 0.5 + 0.45 * torch.stack(
        [
            torch.sin(3.1 * p[:, 0] + 0.3),
            torch.sin(2.7 * p[:, 1] + 1.7),
            torch.sin(3.7 * p[:, 2] + 3.1),
        ],
        -1,
    )
    return torch.clamp(c, 0.02, 1.0).to(torch.float32)


def uniform(g: torch.Generator, lo: float, hi: float, shape, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, dtype=torch.float64, device=device)


def scene_trained(n: int, g: torch.Generator, center, device):
    """bench.py's trained-statistics scene, drawn on the device: Gaussians
    on the surface of the parity blob around ``center`` (opacity 0.85-0.99,
    the normal axis a tenth of the tangent axes, rotated to the radial
    normal), with the depth complexity and tile occupancy of a trained
    checkpoint. Returns float32 (means, scales, quats, opacities, colors)."""
    d = fibonacci_sphere(n, device)
    r = blob_surface(d)
    means = d * r[:, None] + torch.tensor(center, dtype=torch.float64, device=device)
    # Tangent spacing ~ sqrt(area / n); trained scales ~ 1.5-4x the spacing.
    spacing = math.sqrt(4 * math.pi * 0.72**2 / n)
    t_scale = spacing * torch.exp(uniform(g, math.log(1.5), math.log(4.0), (n,), device))
    scales = torch.stack([t_scale, t_scale, t_scale / 10.0], -1)
    # The quaternion rotating +z to the surface normal (~radial for the blob).
    z = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=device)
    v = torch.linalg.cross(z.expand_as(d), d, dim=-1)
    w_ = 1.0 + d @ z
    quats = torch.cat([w_[:, None], v], -1)
    quats = quats / torch.clamp(torch.linalg.norm(quats, dim=-1, keepdim=True), min=1e-9)
    opac = uniform(g, 0.85, 0.99, (n,), device)
    colors = blob_colors(means)
    f = lambda x: x.to(torch.float32)  # noqa: E731
    return f(means), f(scales), f(quats), f(opac), colors
