"""The benchmark's plain reference: a frozen copy of the port's eager code.

Copied from `apf_quadruped_tpu_torch` (its CPU path: plain PyTorch ops,
batched over scenarios) under this package's own name, so that a later
change to the program does not move the yardstick.  What differs from the
program:

  * no CUDA kernel and no captured graph: `ops/chol.py` holds the plain
    Cholesky and triangular solves only, the planner's kernel backends
    resolve to the plain scan (`ops/riccati.py`), and the loop's head,
    ticks and tail, the WBC solve and the QP run op by op on any device;
  * `stop_at`: the plan's interior point (`planner.plan`,
    `ops/riccati.solve_stage_qp`), the WBC's QP (`wbc._solve_eager`,
    `ops/qpsolve._solve_qp_eager`) and the loop's plan
    (`runtime/loop.run_cycle(plan_stop_at=...)`) can stop each lane after
    a given number of iterations instead of at the tolerances, so that a
    solution is compared at the iteration the judged side stopped at;
  * `_precision.tf32_control()`: the control's switch, TF32 on where the
    configuration states it off.

The module docstrings are the program's, as copied; where they speak of
kernels and graphs, those routes are not here.  This package imports
nothing of the program, of JAX or of the JAX package.
"""
