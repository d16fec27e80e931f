"""apf_quadruped_tpu_torch — the PyTorch / CUDA port of apf_quadruped_tpu.

The JAX package beside it (`apf_quadruped_tpu/`) is the reference: every
module here keeps its counterpart's name, function names, NamedTuple
fields and array layouts (batch first, horizon next), and the tests feed
both packages the same numpy inputs.

Ported so far (the MPC plan path, `planner.plan`):
    config.py, models/dogbot.py — the JAX package's pure-Python files,
                  shared rather than copied (see _shared.py)
    ops/rotations.py, models/srb.py, gait.py — plain tensor code
    ops/riccati.py — the stage-QP Riccati IPM as plain PyTorch (the CPU
                  path, and the plain version of the CUDA kernel)
    ops/cuda_riccati.py + csrc/resident_ipm.cu — the resident IPM as one
                  hand-written CUDA kernel for Hopper (sm_90a)
    planner.py — the Riccati plan path; convert.py carries JAX-package
                  NamedTuples across as tensors

Importing the package imports neither jax nor the JAX package; torch is
imported by the modules that need it.
"""

__version__ = "0.1.0"
