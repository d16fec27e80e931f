"""Full-f32 precision guard: the port's "all KKT algebra at highest
precision" rule (README "Design principles").

On the GPU, PyTorch may run float32 matrix products and cuDNN
convolutions in TF32, which keeps about three decimal digits and stalls
the interior point's late iterations.  `highest_precision()` turns TF32
off for its block and restores the previous settings on exit.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    matmul_tf32 = torch.backends.cuda.matmul.allow_tf32
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul_tf32
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
        torch.set_float32_matmul_precision(precision)
