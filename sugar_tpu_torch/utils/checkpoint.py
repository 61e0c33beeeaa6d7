"""Checkpoint / resume for training state.

Port of ``sugar_tpu/utils/checkpoint.py``. The reference saves full
state_dicts at milestones (sugar_model.py:2296-2301, coarse_sdf.py:782-793)
and each downstream stage reloads from disk; here a milestone holds model
params, Adam state, densifier stats, the KNN table and the iteration
counter, so any stage can resume idempotently.

One format only: a numpy ``.npz`` whose leaves are keyed by their path in
the state (``params/xyz``, ``adam/mu/xyz``, ``iteration``, ...), written
to a temporary name and renamed into place. The JAX package prefers orbax
and keys its npz leaves by treedef position, so the two packages'
milestones are not interchangeable; models cross between them as PLY.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    """{path: numpy leaf} of a tree of dicts, dataclasses, tensors and
    Python numbers."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree.detach().cpu().numpy()}
    if isinstance(tree, (bool, int, float, np.ndarray, np.generic)):
        return {prefix[:-1]: np.asarray(tree)}
    raise TypeError(f"cannot checkpoint a leaf of type {type(tree).__name__} at {prefix[:-1]!r}")


def save_checkpoint(path: str, state: dict[str, Any]) -> None:
    """Save a state (nested dicts / dataclasses of tensors and numbers) to
    ``path`` (``.npz`` appended when missing). The file appears whole or
    not at all."""
    final = _npz(path)
    os.makedirs(os.path.dirname(final) or ".", exist_ok=True)
    tmp = final + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **_flatten(state))
    os.replace(tmp, final)


def _unflatten(like: Any, data, prefix: str = "") -> Any:
    """The leaves of ``data`` in the plain structure of ``like``
    (dataclasses become dicts)."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        like = {f.name: getattr(like, f.name) for f in dataclasses.fields(like)}
    if isinstance(like, dict):
        return {k: _unflatten(v, data, f"{prefix}{k}/") for k, v in like.items()}
    return data[prefix[:-1]]


def load_checkpoint(path: str, like: dict[str, Any]) -> dict[str, Any]:
    """Load a checkpoint as numpy leaves in the structure of ``like`` (with
    dataclasses as plain dicts)."""
    with np.load(_npz(path)) as data:
        return _unflatten(like, data)


def milestone_path(base_dir: str, iteration: int) -> str:
    return os.path.join(base_dir, f"milestone_{iteration}")


def save_milestone(base_dir: str, iteration: int, state: dict[str, Any]) -> str:
    """Save a training-state milestone (reference analog: the state_dict
    saves at coarse_sdf.py:782-793 / refine.py:833-845)."""
    path = milestone_path(base_dir, iteration)
    save_checkpoint(path, state)
    return path


def latest_milestone(base_dir: str, before: int | None = None) -> int | None:
    """Highest milestone iteration saved under ``base_dir`` (< ``before``
    if given), or None."""
    if not os.path.isdir(base_dir):
        return None
    best = None
    for name in os.listdir(base_dir):
        if not (name.startswith("milestone_") and name.endswith(".npz")):
            continue
        try:
            it = int(name[len("milestone_"):-4])
        except ValueError:
            continue
        if before is not None and it >= before:
            continue
        if best is None or it > best:
            best = it
    return best


def load_milestone(base_dir: str, iteration: int, like: dict[str, Any]) -> dict[str, Any]:
    return load_checkpoint(milestone_path(base_dir, iteration), like)


def _restore(like: Any, data: Any) -> Any:
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return type(like)(**{f.name: _restore(getattr(like, f.name), data[f.name])
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _restore(v, data[k]) for k, v in like.items()}
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(data, dtype=like.dtype, device=like.device)
    if isinstance(like, (bool, int, float)):
        return type(like)(data)
    return data


def restore_structured(path: str, like: Any) -> Any:
    """Load a checkpoint and rebuild the structure of ``like``: its
    dataclasses, its Python numbers, and its tensors with their dtypes on
    their devices."""
    return _restore(like, load_checkpoint(path, like))
