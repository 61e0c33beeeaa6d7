"""The numbers that decide ``correct``, each held to its limit.

Training (three steps that the timed path ran, followed by the reference
from the same inputs):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the norms of the
  first step's gradient (the program's worked out from Adam's state after
  the step), against the larger of the reference leaf's norm and the
  median leaf's;
- ``change_gap``: the same for the change of the parameters over the
  three steps, over the leaves whose reference gradient is not below a
  thousandth of the median leaf's (such a leaf moves under Adam by
  round-off alone).

Serving (sampled views as they reached the host, against the reference's
image cast to uint8 the same way):

- ``img_mae``: the worst view's mean absolute difference, in uint8 levels;
- ``tile_mae_max``: the worst 16x16 tile's mean absolute difference.
"""

from __future__ import annotations

import statistics

import torch


def _norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to("cpu", torch.float64)))


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: dict(losses [3 floats], g1 {leaf: tensor}, change
    {leaf: tensor})."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    gr = {k: _norm(v) for k, v in ref["g1"].items()}
    gp = {k: _norm(prog["g1"][k]) for k in gr}
    gmed = statistics.median(gr.values())
    grad_gap = max(abs(gp[k] - gr[k]) / max(gr[k], gmed) for k in gr)
    moved = [k for k in gr if gr[k] >= 1e-3 * gmed]
    dr = {k: _norm(ref["change"][k]) for k in gr}
    dp = {k: _norm(prog["change"][k]) for k in gr}
    dmed = statistics.median(dr[k] for k in moved)
    change_gap = max(abs(dp[k] - dr[k]) / max(dr[k], dmed) for k in moved)
    return dict(loss_gap=loss_gap, grad_gap=grad_gap, change_gap=change_gap)


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(img.to(torch.float32), 0.0, 1.0) * 255.0).to(torch.uint8)


def serve_numbers(pairs: list) -> dict:
    """``pairs``: [(served uint8 (H, W, 3), reference float (H, W, 3))]."""
    mae, tile = 0.0, 0.0
    for served, ref in pairs:
        d = (served.to(torch.float32).cpu() - to_uint8(ref).to(torch.float32).cpu()).abs()
        mae = max(mae, float(d.mean()))
        h, w = d.shape[0] // 16 * 16, d.shape[1] // 16 * 16
        t = d[:h, :w].reshape(h // 16, 16, w // 16, 16, -1).mean(dim=(1, 3, 4))
        tile = max(tile, float(t.max()))
    return dict(img_mae=mae, tile_mae_max=tile)


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
