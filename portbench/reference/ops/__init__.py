"""Numerical building blocks: rotations, the stage-QP Riccati IPM and its
CUDA kernel, the batched SPD factor / substitution and its CUDA kernels, the
dense QP solver of the whole-body control."""
