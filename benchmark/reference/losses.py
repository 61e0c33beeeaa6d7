"""Plain PyTorch reference of the training loss and optimizer of 3DGS and
SuGaR, written for the benchmark from the published descriptions:

- loss = 0.8 L1 + 0.2 (1 - SSIM) of the image clipped to [0, 1]
  (gaussian_splatting/train.py:91-92; SSIM with an 11x11 Gaussian window
  of sigma 1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2, utils/loss_utils.py);
- Adam with eps 1e-15 and per-group learning rates, the position rate on
  the exponential schedule get_expon_lr_func (general_utils.py:24-56).

The clip takes maximum then minimum, so that a pixel exactly at 0 passes
half of its gradient, as numpy's and JAX's clip define it. Imports nothing
of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _window(dtype, device, size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float64)
    g = torch.exp(-((xs - size // 2) ** 2) / (2 * sigma**2))
    return (g / g.sum()).to(torch.float32).to(dtype=dtype, device=device)


def _blur(x: torch.Tensor) -> torch.Tensor:
    """Separable Gaussian blur of (1, C, H, W), zero same-padding, per channel."""
    c = x.shape[1]
    g = _window(x.dtype, x.device)
    x = F.conv2d(x, g.view(1, 1, -1, 1).expand(c, 1, -1, 1), padding=(5, 0), groups=c)
    return F.conv2d(x, g.view(1, 1, 1, -1).expand(c, 1, 1, -1), padding=(0, 5), groups=c)


def ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two (H, W, C) images."""
    a = a.permute(2, 0, 1)[None]
    b = b.permute(2, 0, 1)[None]
    c1, c2 = 0.01**2, 0.03**2
    mu1, mu2 = _blur(a), _blur(b)
    s1 = _blur(a * a) - mu1 * mu1
    s2 = _blur(b * b) - mu2 * mu2
    s12 = _blur(a * b) - mu1 * mu2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / ((mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def clip01(x: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, zero), zero + 1.0)


def rgb_loss(img: torch.Tensor, gt: torch.Tensor, dssim: float = 0.2) -> torch.Tensor:
    img = clip01(img)
    return (1.0 - dssim) * torch.mean(torch.abs(img - gt)) + dssim * (1.0 - ssim(img, gt))


def expon_lr(lr_init: float, lr_final: float, max_steps: int, step: int) -> float:
    """Log-linear interpolation from lr_init to lr_final (no delay steps)."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def adam(params: dict, grads: dict, state: dict, lrs: dict, b1=0.9, b2=0.999, eps=1e-15):
    """One Adam step over every leaf; returns (new params, new state)."""
    count = state["count"] + 1
    c1, c2 = 1.0 - b1**count, 1.0 - b2**count
    new_p, mu, nu = {}, {}, {}
    for k, p in params.items():
        g = grads[k]
        mu[k] = b1 * state["mu"][k] + (1 - b1) * g
        nu[k] = b2 * state["nu"][k] + (1 - b2) * g * g
        new_p[k] = p - lrs[k] * (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
    return new_p, dict(mu=mu, nu=nu, count=count)


def adam_init(params: dict) -> dict:
    return dict(mu={k: torch.zeros_like(v) for k, v in params.items()},
                nu={k: torch.zeros_like(v) for k, v in params.items()}, count=0)
