"""Image losses: L1, L2, windowed SSIM, PSNR and the training loss
0.8 L1 + 0.2 (1 - SSIM). Their gradients come from autograd.

Port of ``sugar_tpu/utils/losses.py``. SSIM is the reference's: 11x11
Gaussian window with sigma 1.5, per-channel blur with zero same-padding,
C1=0.01^2, C2=0.03^2, mean over all pixels. Images are channel-last
(H, W, C) float32 in [0, 1].

The separable blur is written as weighted sums of shifted slices rather
than a convolution: cuDNN would run a float32 convolution in TF32 on the
card by default, and the sums stay in full float32 on every device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def l2_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """PSNR as in gaussian_splatting/utils/image_utils.py (per-image MSE)."""
    mse = torch.mean((pred - target) ** 2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> tuple[float, ...]:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2 * sigma**2))
    g = g / g.sum()
    return tuple(float(v) for v in g.astype(np.float32))


def _depthwise_blur(img: torch.Tensor, window_size: int, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur, zero same-padding, per channel. img (H, W, C)."""
    g = _gaussian_window(window_size, sigma)
    pad = window_size // 2
    h, w, _ = img.shape
    x = F.pad(img, (0, 0, 0, 0, pad, pad))  # pad H
    x = sum(g[k] * x[k : k + h] for k in range(window_size))
    x = F.pad(x, (0, 0, pad, pad))  # pad W
    return sum(g[k] * x[:, k : k + w] for k in range(window_size))


def ssim(
    img1: torch.Tensor,
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """Mean SSIM over the image (reference loss_utils.py:33-63)."""
    c1, c2 = 0.01**2, 0.03**2
    mu1 = _depthwise_blur(img1, window_size, sigma)
    mu2 = _depthwise_blur(img2, window_size, sigma)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _depthwise_blur(img1 * img1, window_size, sigma) - mu1_sq
    sigma2_sq = _depthwise_blur(img2 * img2, window_size, sigma) - mu2_sq
    sigma12 = _depthwise_blur(img1 * img2, window_size, sigma) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return torch.mean(ssim_map)


def rgb_loss_l1_dssim(
    pred: torch.Tensor, target: torch.Tensor, dssim_factor: float = 0.2
) -> torch.Tensor:
    """0.8 * L1 + 0.2 * (1 - SSIM): the training loss of the vanilla trainer
    (gaussian_splatting/train.py:91-92) and the SuGaR coarse stages."""
    return (1.0 - dssim_factor) * l1_loss(pred, target) + dssim_factor * (
        1.0 - ssim(pred, target)
    )
