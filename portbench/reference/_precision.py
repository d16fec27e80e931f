"""The precision guard, with the control's switch.

Frozen from the port's _precision.py.  `highest_precision()` turns TF32
off for its block, as the configuration states, and restores the previous
settings on exit.  Inside `tf32_control()` it turns TF32 on instead: the
reference computed one precision below the configuration's, which the
benchmark's control puts in the program's place.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_TF32 = contextvars.ContextVar("portbench_reference_tf32", default=False)


@contextlib.contextmanager
def tf32_control():
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


@contextlib.contextmanager
def highest_precision():
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    tf32 = _TF32.get()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(precision)
