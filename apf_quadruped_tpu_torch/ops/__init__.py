"""Numerical building blocks: rotations, the stage-QP Riccati IPM and its
CUDA kernel."""
