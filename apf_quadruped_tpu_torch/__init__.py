"""apf_quadruped_tpu_torch — the PyTorch / CUDA port of apf_quadruped_tpu.

The JAX package beside it (`apf_quadruped_tpu/`) is the reference: every
module here keeps its counterpart's name, function names, NamedTuple
fields and array layouts (batch first, horizon next), and the tests feed
both packages the same numpy inputs.

The port does all that the JAX package does: the MPC plan path
(`planner.plan`, every backend), the batched closed loop
(`runtime/sweep.run_batch` -> `runtime/loop.run_cycle`), resumable and
sharded sweeps, the zoo robots and the whole command line, with every
SolverConfig option (stage_bf16: A and B at bf16 in the resident and
fused kernels, which widen them to float32 on chip).
    config.py, models/dogbot.py, models/zoo.py, runtime/native.py,
    runtime/viz.py — the port's own copies of the JAX package's
                  pure-Python files
    ops/rotations.py, models/srb.py, gait.py — plain tensor code
    ops/riccati.py — the stage-QP Riccati IPM as plain PyTorch (the CPU
                  path, and the plain version of the CUDA kernel)
    ops/cuda_riccati.py + csrc/resident_ipm.cu, csrc/fused_riccati.cu —
                  the resident IPM as one hand-written CUDA kernel for
                  Hopper (sm_90a), and the fused IPM around three kernels,
                  each with a float32 and a bf16-storage instance
    planner.py — the plan: Riccati backends and the condensed dense QP
    ops/chol.py, ops/cuda_chol.py + csrc/spd_chol.cu — the batched SPD
                  factor / substitution / factor-and-solve: CUDA kernels,
                  and their plain versions on the CPU
    ops/qpsolve.py — the dense interior-point QP of the whole-body control
    models/kinematics.py, models/rbd.py — leg kinematics and 18-DoF
                  rigid-body dynamics in closed form
    apf.py, foothold.py, swing.py, wbc.py — navigation, foothold selection,
                  swing splines, the whole-body QP
    sim/ — terrain, disturbances, penalty-contact physics
    runtime/ — the momentum observer, the closed loop, the sweep (one
                  device, sharded, resumable), checkpoints, profiling
    parallel/ — the scenario mesh over devices and processes
                  (torch.distributed)
    __main__.py — the `run`, `sweep` and `bench` commands
    _device.py — the entry points' device rule (the card unless asked)
    convert.py — carries JAX-package NamedTuples across as tensors

Importing the package imports neither jax nor the JAX package; torch is
imported by the modules that need it.
"""

__version__ = "0.1.0"
