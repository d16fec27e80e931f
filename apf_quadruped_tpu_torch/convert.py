"""Carry problem data between the JAX package and the port.

The JAX package's NamedTuples (StageQP, WarmStart, MpcRefs) and arrays
(the packed SRB state) become the port's NamedTuples of tensors on a
given device, and the port's outputs become numpy again.  Anything numpy
can read is accepted (numpy arrays, jax arrays), and a mapping with the
same field names works in place of a NamedTuple.  Dtypes are kept: the
caller decides float32 or float64 on the JAX side.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .ops.riccati import StageQP, WarmStart
from .planner import MpcRefs


def tensor(value, device=None) -> torch.Tensor | None:
    """numpy-readable array -> tensor on `device` (None passes through)."""
    if value is None:
        return None
    return torch.as_tensor(np.array(value), device=device)


def _carry(obj, cls, device):
    def field(name):
        if isinstance(obj, Mapping):
            return obj.get(name)
        return getattr(obj, name, None)
    return cls(**{f: tensor(field(f), device) for f in cls._fields})


def stage_qp(qp, device=None) -> StageQP:
    return _carry(qp, StageQP, device)


def warm_start(warm, device=None) -> WarmStart:
    return _carry(warm, WarmStart, device)


def mpc_refs(refs, device=None) -> MpcRefs:
    return _carry(refs, MpcRefs, device)


def to_numpy(value):
    """Tensors (and NamedTuples of them, nested) -> numpy arrays."""
    if value is None:
        return None
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    raise TypeError(f"cannot convert {type(value).__name__} to numpy")
