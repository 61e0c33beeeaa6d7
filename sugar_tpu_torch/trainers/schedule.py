"""Deterministic per-iteration schedules (camera order, RNG) for trainers.

Port of ``sugar_tpu/trainers/schedule.py``. The reference trainers draw a
fresh random camera permutation per epoch and consume it back to front
(gaussian_splatting/train.py:76-78). The camera index and the random
stream at iteration i are pure functions of (seed, i), so a resumed run
replays the uninterrupted one. ``CameraSchedule`` is numpy and gives the
JAX package's order exactly; ``iteration_generator`` replaces
``iteration_key``: a ``torch.Generator`` seeded from (seed, i). Its
numbers are not ``jax.random``'s, so tests feed both packages one draw.
"""

from __future__ import annotations

import numpy as np
import torch


class CameraSchedule:
    """step -> camera index; pure in (seed, n_cameras, step)."""

    def __init__(self, seed: int, n_cameras: int):
        self.seed = int(seed)
        self.n = max(int(n_cameras), 1)
        self._rng = np.random.default_rng(seed)
        self._epoch = -1
        self._perm: np.ndarray | None = None

    def index(self, step: int) -> int:
        epoch, pos = divmod(int(step), self.n)
        if epoch < self._epoch:
            # Replaying an earlier epoch: restart the generator.
            self._rng = np.random.default_rng(self.seed)
            self._epoch = -1
        while self._epoch < epoch:
            self._perm = self._rng.permutation(self.n)
            self._epoch += 1
        # Reference consumes via list.pop() = back-to-front.
        return int(self._perm[self.n - 1 - pos])


def iteration_generator(
    seed: int, iteration: int, device: str | torch.device = "cuda"
) -> torch.Generator:
    """Per-iteration generator on ``device``, pure in (seed, iteration)."""
    state = np.random.SeedSequence((int(seed), int(iteration))).generate_state(1, np.uint64)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]) & ((1 << 63) - 1))
    return gen
