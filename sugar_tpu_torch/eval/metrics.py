"""Evaluation: PSNR / SSIM / LPIPS over the held-out split.

Port of ``sugar_tpu/eval/metrics.py``. Reference protocol
(metrics.py:154-417 + BASELINE.md): every-8th-image test split,
full-resolution renders capped at 1920 px, PSNR per image then averaged,
SSIM with the 11x11/sigma-1.5 window, LPIPS with a VGG backbone.

The metrics run on the render's device (the CPU for a numpy render), with
PSNR and SSIM from ``utils/losses.py``. LPIPS needs pretrained VGG weights,
read from an npz file; without one :func:`make_lpips` returns ``None`` and
the report carries PSNR and SSIM only, with the same schema as the
reference writer (metrics.py:399-417).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from sugar_tpu_torch.utils import losses


def _as_image(x, device=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=torch.float32, device=device)
    return torch.clamp(t, 0.0, 1.0)


def evaluate_renders(
    render_fn: Callable[[int], "torch.Tensor | np.ndarray"],
    gt_images: list[np.ndarray],
    indices: list[int],
    lpips_weights: str | None = None,
) -> dict:
    """Evaluate render_fn(camera_index) against ground truth on `indices`.

    LPIPS is only reported as ``lpips`` when the weights file carries
    calibrated heads; uncalibrated placeholder files (written by
    export_lpips_weights --allow-uncalibrated) are reported under
    ``lpips_uncalibrated`` so they can never masquerade as the metric."""
    psnrs, ssims, lpips_vals = [], [], []
    lp = make_lpips(lpips_weights) if lpips_weights else None
    lpips_key = "lpips"
    if lp is not None and lpips_weights and not _weights_calibrated(lpips_weights):
        lpips_key = "lpips_uncalibrated"
    for i in indices:
        img = _as_image(render_fn(i))
        gt = _as_image(gt_images[i], img.device)
        psnrs.append(float(losses.psnr(img, gt)))
        ssims.append(float(losses.ssim(img, gt)))
        if lp is not None:
            lpips_vals.append(float(lp(img, gt)))
    out = dict(
        psnr=float(np.mean(psnrs)) if psnrs else float("nan"),
        ssim=float(np.mean(ssims)) if ssims else float("nan"),
        n_images=len(indices),
        per_image_psnr=psnrs,
        per_image_ssim=ssims,
    )
    if lpips_vals:
        out[lpips_key] = float(np.mean(lpips_vals))
    return out


def _weights_calibrated(weights_path: str) -> bool:
    """True iff the npz declares calibrated LPIPS heads. Legacy files
    without the flag are trusted unless their name marks them."""
    if ".uncalibrated." in os.path.basename(weights_path):
        return False
    try:
        with np.load(weights_path) as w:
            if "calibrated" in w:
                return bool(int(w["calibrated"]))
    except (OSError, ValueError):
        return False
    return True


def write_metrics_json(path: str, scene_name: str, results: dict) -> None:
    """Same shape as the reference's ./output/metrics JSON
    (metrics.py:399-417)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {scene_name: results}
    if os.path.exists(path):
        with open(path) as f:
            try:
                payload = {**json.load(f), **payload}
            except json.JSONDecodeError:
                pass
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


# ---------------------------------------------------------------- LPIPS ----
# VGG16-based LPIPS. Weights layout (npz): conv weights "features.N.weight"/
# "features.N.bias" (torchvision VGG16 indices) + linear heads "lin{k}" of
# shape (C_k,). Only active when weights exist.

_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
_SLICE_ENDS = (3, 8, 15, 22, 29)  # relu1_2 ... relu5_3 torchvision indices
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def make_lpips(weights_path: str):
    """LPIPS(img, gt) over (H, W, 3) images in [0, 1], on the image's device,
    or None without a weights file. The convolutions run in float32 on the
    card too: TF32 is turned off for the call."""
    if not os.path.exists(weights_path):
        return None
    w = dict(np.load(weights_path))
    on_device: dict[torch.device, dict[str, torch.Tensor]] = {}

    def weights(dev):
        if dev not in on_device:
            on_device[dev] = {k: torch.as_tensor(v, device=dev) for k, v in w.items()}
        return on_device[dev]

    def vgg_features(x, wd):  # x (1, 3, H, W)
        feats = []
        h = x
        idx = 0
        for c in _VGG_CFG:
            if c == "M":
                h = F.max_pool2d(h, 2)
                idx += 1
            else:
                h = F.conv2d(h, wd[f"features.{idx}.weight"], padding=1)
                h = torch.relu(h + wd[f"features.{idx}.bias"][None, :, None, None])
                idx += 2
                if idx - 1 in _SLICE_ENDS:
                    feats.append(h)
        return feats

    def lpips(img, gt):
        img = torch.as_tensor(img, dtype=torch.float32)
        dev = img.device
        wd = weights(dev)
        shift = torch.as_tensor(_SHIFT, device=dev)
        scale = torch.as_tensor(_SCALE, device=dev)

        def prep(a):
            a = torch.as_tensor(a, dtype=torch.float32, device=dev)[None] * 2.0 - 1.0
            return ((a - shift) / scale).permute(0, 3, 1, 2)

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            with torch.no_grad():
                f1 = vgg_features(prep(img), wd)
                f2 = vgg_features(prep(gt), wd)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        total = torch.zeros((), device=dev)
        for k, (a, b) in enumerate(zip(f1, f2)):
            a = a / torch.clamp(torch.linalg.vector_norm(a, dim=1, keepdim=True), min=1e-10)
            b = b / torch.clamp(torch.linalg.vector_norm(b, dim=1, keepdim=True), min=1e-10)
            d = (a - b) ** 2
            lin = wd[f"lin{k}"].reshape(1, -1, 1, 1)
            total = total + torch.mean(torch.sum(d * lin, dim=1))
        return total

    return lpips
