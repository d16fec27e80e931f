"""Carry problem data and state between the JAX package and the port.

The JAX package's NamedTuples (StageQP, WarmStart, MpcRefs, QPData,
WbcState, WbcRefs, Terrain, Scenario, LoopState with its SimState,
ApfState and ObserverState) and arrays become the port's NamedTuples of
tensors on a given device, and the port's outputs become numpy again.
Anything numpy can read is accepted (numpy arrays, jax arrays), and a
mapping with the same field names works in place of a NamedTuple; a
flat mapping with dotted keys ("sim.p_base", as tests/data/
make_loop_golden.py writes them) works through `unflatten`.  Dtypes are
kept: the caller decides float32 or float64 on the JAX side.  The JAX
package's state is single-scenario under vmap and batched here, so a
batch of JAX states is passed with its scenario axis in front.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .apf import ApfState
from .ops.qpsolve import QPData
from .ops.riccati import StageQP, WarmStart
from .planner import MpcRefs
from .runtime.loop import LoopState
from .runtime.observer import ObserverState
from .runtime.sweep import Scenario
from .sim.physics import SimState
from .sim.terrain import Terrain
from .wbc import WbcRefs, WbcState

# NamedTuple fields that hold NamedTuples themselves
_NESTED = {LoopState: {"sim": SimState, "apf": ApfState,
                       "obs": ObserverState}}


def tensor(value, device=None) -> torch.Tensor | None:
    """numpy-readable array -> tensor on `device` (None passes through)."""
    if value is None:
        return None
    return torch.as_tensor(np.array(value), device=device)


def _field(obj, name):
    if isinstance(obj, Mapping):
        return obj.get(name)
    return getattr(obj, name, None)


def _carry(obj, cls, device):
    nested = _NESTED.get(cls, {})
    return cls(**{f: (_carry(_field(obj, f), nested[f], device)
                      if f in nested else tensor(_field(obj, f), device))
                  for f in cls._fields})


def unflatten(data: Mapping, prefix: str, cls, device=None):
    """A NamedTuple tree from a flat mapping with keys "<prefix>.<field>"
    (nested fields "<prefix>.<field>.<field>")."""
    nested = _NESTED.get(cls, {})

    def get(f):
        key = f"{prefix}.{f}"
        if f in nested:
            return unflatten(data, key, nested[f], device)
        return tensor(data[key], device) if key in data else None
    return cls(**{f: get(f) for f in cls._fields})


def stage_qp(qp, device=None) -> StageQP:
    return _carry(qp, StageQP, device)


def warm_start(warm, device=None) -> WarmStart:
    return _carry(warm, WarmStart, device)


def mpc_refs(refs, device=None) -> MpcRefs:
    return _carry(refs, MpcRefs, device)


def qp_data(qp, device=None) -> QPData:
    return _carry(qp, QPData, device)


def wbc_state(st, device=None) -> WbcState:
    return _carry(st, WbcState, device)


def wbc_refs(ref, device=None) -> WbcRefs:
    return _carry(ref, WbcRefs, device)


def scenario(scn, device=None) -> Scenario:
    return _carry(scn, Scenario, device)


def loop_state(st, device=None) -> LoopState:
    return _carry(st, LoopState, device)


def terrain(t, device=None) -> Terrain:
    """A JAX Terrain (or mapping) -> the port's; extent and res stay
    Python numbers."""
    return Terrain(mu_map=tensor(_field(t, "mu_map"), device),
                   extent=float(_field(t, "extent")),
                   res=int(_field(t, "res")),
                   h_map=tensor(_field(t, "h_map"), device))


def to_numpy(value):
    """Tensors (and NamedTuples of them, nested) -> numpy arrays."""
    if value is None or isinstance(value, (bool, int, float)):
        return value
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(to_numpy(v) for v in value))
    raise TypeError(f"cannot convert {type(value).__name__} to numpy")
