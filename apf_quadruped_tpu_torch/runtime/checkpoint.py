"""Checkpoint / resume for long sweeps.

Port of apf_quadruped_tpu/runtime/checkpoint.py with torch.save in place
of orbax.  A checkpoint is one file holding a tree of dicts, lists,
tuples and NamedTuples of tensors and Python numbers; tensors are stored
on the host with their dtypes (bool, int32, float32, float64 come back as
they went in).  NamedTuples are stored as plain dicts, so the file loads
with `torch.load(weights_only=True)`; `restore(path, like=...)` rebuilds
the NamedTuples from the `like` tree.

A save writes a temporary file in the same directory and renames it over
the checkpoint (`os.replace`): a process killed during a save leaves the
previous checkpoint whole.
"""

from __future__ import annotations

import os
from typing import Any

import torch


def _plain(tree):
    """tree -> dicts / lists / tuples of host tensors and numbers."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, tuple) and hasattr(tree, "_asdict"):
        return {k: _plain(v) for k, v in tree._asdict().items()}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _rebuild(raw, like, device):
    """`raw` in the structure of `like`, tensors on `device` (None: where
    the `like` leaf lies)."""
    if isinstance(like, torch.Tensor):
        return raw.to(like.device if device is None else device)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(**{k: _rebuild(raw[k], v, device)
                             for k, v in like._asdict().items()})
    if isinstance(like, dict):
        return {k: _rebuild(raw[k], v, device) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(r, v, device) for r, v in zip(raw, like))
    return raw


def save(path: str, tree: Any) -> int:
    """Write `tree` to the file `path`, atomically; returns the bytes
    written."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            torch.save(_plain(tree), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return os.path.getsize(path)


def restore(path: str, like: Any = None, device=None) -> Any:
    """Read a checkpoint.  With `like`, the tree comes back in its
    structure (NamedTuples included) and each tensor on `device`, by
    default the device of the `like` leaf; without it, as dicts and lists
    of tensors on `device` (default the host)."""
    raw = torch.load(os.path.abspath(path), map_location="cpu",
                     weights_only=True)
    return _rebuild(raw, raw if like is None else like, device)


def exists(path: str) -> bool:
    return os.path.exists(os.path.abspath(path))
