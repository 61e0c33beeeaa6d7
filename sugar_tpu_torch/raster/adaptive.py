"""Capacity auto-grow for the fixed-capacity rasterizer.

Port of ``sugar_tpu/raster/adaptive.py``. The render runs with fixed
capacities and returns overflow counters; when a counter is nonzero the
matching capacity grows and the view is rendered again:

- ``tile_cap``     — per-Gaussian tile-rect slots. Counter: the rect part
  of ``bin_overflow``. Grows to cover ``max_tiles_touched``.
- ``big_cap``      — bucket-B rows for Gaussians whose rect exceeds
  ``cap_a``. Counter: ``big_overflow``. Grows toward ``num_big``.

  ``tile_cap``, ``cap_a`` and ``big_cap`` bound the CPU route of
  ``raster.fused.bin_fused`` and the tile-sharded path
  (``parallel/render.py``) only. On the card ``bin_fused`` bins every
  rect tile, so neither counter rises there and the two caps never grow;
  it reports no ``max_tiles_touched`` or ``num_big``.
- ``dup_capacity`` — total duplication slots. Counter: ``cap_overflow``.
  Grows to ``num_rendered`` plus slack, rounded to the chunk size.
- ``k_max``        — per-tile compositing depth. Counter:
  ``tile_overflow``. Grows to ``max_tile_count``.

``render_adaptive`` loops until all counters are zero, so one call gives
the exact uncapped image. ``CapState`` is the lag-checked form the
trainers use (``CapState.check_lagged``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from sugar_tpu_torch.utils import profiling

_CHUNK = 256  # = tile_composite.C_CHUNK


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


@dataclasses.dataclass
class RasterCaps:
    """Rasterizer capacities."""

    tile_cap: int = 8
    dup_capacity: int | None = None  # None = rasterize_gaussians' default
    k_max: int = 4096
    # Fused-binning bucket sizing (raster/fused.py, its CPU route): every
    # Gaussian owns cap_a rect slots; Gaussians with bigger rects get one
    # of big_cap wide rows. None = render_fused's n-derived default.
    cap_a: int = 4
    big_cap: int | None = None

    def grown(self, ovf: dict[str, int]) -> "RasterCaps":
        """Return caps covering the observed overflow diagnostics.

        ``ovf`` holds ints for (bin_overflow, big_overflow, cap_overflow,
        tile_overflow, max_tiles_touched, max_tile_count, num_rendered,
        num_big).
        """
        tile_cap = self.tile_cap
        big = ovf.get("big_overflow", 0)
        # bin_overflow folds all three truncations; the per-gaussian rect
        # part is what max_tiles_touched sizes.
        rect = ovf.get("bin_overflow", 0) - ovf.get("cap_overflow", 0) - big
        big_cap = self.big_cap
        if rect > 0:
            # Round to 16, not pow2: the fused expansion costs
            # (tile_cap - cap_a) * big_cap slots.
            tile_cap = _round_up(max(ovf["max_tiles_touched"], tile_cap + 1), 16)
            if big_cap is None and "num_big" in ovf:
                # Pin bucket-B rows to the observed big-Gaussian count (x2
                # slack) instead of the n-derived default.
                big_cap = _next_pow2(max(2 * ovf["num_big"], 1024))
        if big > 0:
            base = big_cap if big_cap is not None else 0
            big_cap = _next_pow2(max(ovf.get("num_big", base * 2 + 1), base + 1))
        dup_capacity = self.dup_capacity
        if ovf.get("cap_overflow", 0) > 0:
            need = int(ovf["num_rendered"] * 1.25)
            base = dup_capacity if dup_capacity is not None else need
            dup_capacity = _round_up(max(need, base + 1), _CHUNK)
        k_max = self.k_max
        if ovf.get("tile_overflow", 0) > 0:
            k_max = _round_up(max(ovf["max_tile_count"], k_max + 1), _CHUNK)
        return RasterCaps(
            tile_cap=tile_cap, dup_capacity=dup_capacity, k_max=k_max,
            cap_a=self.cap_a, big_cap=big_cap,
        )


_OVF_KEYS = (
    "bin_overflow",
    "big_overflow",
    "cap_overflow",
    "tile_overflow",
    "max_tiles_touched",
    "max_tile_count",
    "num_rendered",
    "num_big",
)


# The counters the training loops log.
LOGGED_OVERFLOW = ("bin_overflow", "big_overflow", "cap_overflow", "tile_overflow")
HOT_STEPS, CHECK_EVERY = 50, 10  # CapState.check_lagged's cadence


def overflow_counters(out: dict[str, Any]) -> dict[str, Any]:
    """The overflow counters a render output holds, unread."""
    return {k: out[k] for k in _OVF_KEYS if k in out}


def logged_overflow(aux: dict[str, Any]) -> dict[str, int]:
    """The counters of ``LOGGED_OVERFLOW`` that ``aux`` holds, as host ints."""
    return read_overflow({k: aux[k] for k in LOGGED_OVERFLOW if k in aux})


@profiling.spanned("caps.read")
def read_overflow(out: dict[str, Any]) -> dict[str, int]:
    """Fetch the overflow diagnostics of a render output as host ints (one
    device-to-host copy)."""
    keys = [k for k in _OVF_KEYS if out.get(k) is not None]
    if not keys:
        return {}
    vals = torch.stack([torch.as_tensor(out[k]).to(torch.int64) for k in keys]).tolist()
    return dict(zip(keys, vals))


def overflowed(ovf: dict[str, int]) -> bool:
    return (
        ovf.get("bin_overflow", 0) > 0
        or ovf.get("cap_overflow", 0) > 0
        or ovf.get("tile_overflow", 0) > 0
    )


def render_adaptive(
    render_fn: Callable[..., dict],
    caps: RasterCaps,
    *args,
    max_grows: int = 8,
    log_fn: Callable[[dict], None] | None = None,
    **kwargs,
) -> tuple[dict, RasterCaps]:
    """Call ``render_fn(*args, tile_cap=, dup_capacity=, k_max=, cap_a=,
    big_cap=, **kwargs)``, growing ``caps`` and rendering again until no
    counter overflows. Returns (output, final caps); the output equals a
    render with unbounded capacities."""
    for _ in range(max_grows):
        out = render_fn(
            *args,
            tile_cap=caps.tile_cap,
            dup_capacity=caps.dup_capacity,
            k_max=caps.k_max,
            cap_a=caps.cap_a,
            big_cap=caps.big_cap,
            **kwargs,
        )
        ovf = read_overflow(out)
        if not overflowed(ovf):
            return out, caps
        new_caps = caps.grown(ovf)
        if log_fn:
            log_fn(dict(event="cap_grow", old=dataclasses.asdict(caps),
                        new=dataclasses.asdict(new_caps), overflow=ovf))
        caps = new_caps
    raise RuntimeError(f"capacity growth did not converge after {max_grows} tries: {ovf}")


class CapState:
    """Lag-checked capacity state for training loops.

    The trainer calls ``check_lagged(it, aux)`` after each step; when the
    PREVIOUS step overflowed the caps grow and ``version`` bumps.
    """

    def __init__(self, caps: RasterCaps, log_fn=None):
        self.caps = caps
        self.version = 0
        self.log_fn = log_fn
        self.grow_events: list[dict] = []
        self.prev_aux: dict[str, Any] | None = None
        self.hot_until: int | None = None

    def check_lagged(self, it: int, aux: dict[str, Any]) -> bool:
        """Given step ``it``'s output ``aux``, observe the previous step's
        counters: every step for ``HOT_STEPS`` iterations after the first
        call (a start or a resume) or a growth, then every
        ``CHECK_EVERY``-th, as the JAX package's loops do. The check after a
        growth still reads a step rendered at the old caps, so one overflow
        can grow the caps twice (ROADMAP.md, queue 5, "double growth").
        True when the caps grew: the caller drops its steps built for the
        old caps."""
        if self.hot_until is None:
            self.hot_until = it + HOT_STEPS
        grew = False
        if self.prev_aux is not None and (it < self.hot_until or it % CHECK_EVERY == 0):
            grew = self.observe(self.prev_aux)
            if grew:
                self.hot_until = it + HOT_STEPS
        self.prev_aux = aux
        return grew

    def key(self) -> tuple:
        return (self.caps.tile_cap, self.caps.dup_capacity, self.caps.k_max,
                self.caps.cap_a, self.caps.big_cap)

    def observe(self, aux: dict[str, Any]) -> bool:
        """Inspect a step's overflow counters; grow caps if needed.

        Returns True when the caps changed."""
        ovf = read_overflow(aux)
        if not overflowed(ovf):
            return False
        new_caps = self.caps.grown(ovf)
        event = dict(
            event="cap_grow",
            old=dataclasses.asdict(self.caps),
            new=dataclasses.asdict(new_caps),
            overflow=ovf,
        )
        self.grow_events.append(event)
        if self.log_fn:
            self.log_fn(event)
        self.caps = new_caps
        self.version += 1
        return True
