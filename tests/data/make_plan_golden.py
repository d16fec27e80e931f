"""Write plan_golden.npz: the JAX package's planner.plan on bench.py's
problem, for chip_smoke.py to hold the port to on a GPU machine that has
no JAX.

B=8, H=20, dt=0.025, SolverConfig() defaults, float32, the scan backend
("riccati", which is what the port's kernel reproduces).  Two plans: a
cold plan of the seed-0 problem, and a replan of the seed-1 problem
warm-started from the cold plan's u/z/s (lane 3 marked invalid, so it
starts cold).  The inputs are built by the port (problems.bench_problem)
and stored beside the outputs.

Run from the repository root:
    JAX_PLATFORMS=cpu python tests/data/make_plan_golden.py
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np

from apf_quadruped_tpu import planner as jplanner
from apf_quadruped_tpu.ops.riccati import WarmStart
from apf_quadruped_tpu_torch import convert, problems
from apf_quadruped_tpu_torch.config import EngineConfig, MpcConfig, SolverConfig

B, H = 8, 20
OUT = Path(__file__).resolve().parent / "plan_golden.npz"


def main():
    cfg = EngineConfig(mpc=MpcConfig(horizon=H, dt=0.025, backend="riccati"),
                       solver=SolverConfig())
    data = {}
    warm = None
    for tag, seed in (("cold", 0), ("warm", 1)):
        x0, refs = problems.bench_problem(cfg, B, seed=seed, device="cpu")
        x0, refs = convert.to_numpy(x0), convert.to_numpy(refs)
        jrefs = jplanner.MpcRefs(contacts=jnp.asarray(refs.contacts),
                                 feet_w=jnp.asarray(refs.feet_w),
                                 x_ref=jnp.asarray(refs.x_ref),
                                 yaw_ref=jnp.asarray(refs.yaw_ref))
        out = jplanner.plan(cfg, jnp.asarray(x0), jrefs, warm=warm)
        assert np.asarray(out.sol.converged).all(), tag
        data.update({f"{tag}_x0": x0, f"{tag}_contacts": refs.contacts,
                     f"{tag}_feet_w": refs.feet_w, f"{tag}_x_ref": refs.x_ref,
                     f"{tag}_yaw_ref": refs.yaw_ref,
                     f"{tag}_forces": np.asarray(out.forces),
                     f"{tag}_states": np.asarray(out.states),
                     f"{tag}_converged": np.asarray(out.sol.converged),
                     f"{tag}_iters": np.asarray(out.sol.iters)})
        valid = np.arange(B) != 3
        warm = WarmStart(u=out.sol.x.reshape(B, H, 12),
                         z=out.sol.z.reshape(B, H, -1),
                         s=out.sol.s.reshape(B, H, -1),
                         valid=jnp.asarray(valid))
        if tag == "cold":
            data.update(warm_u=np.asarray(warm.u), warm_z=np.asarray(warm.z),
                        warm_s=np.asarray(warm.s), warm_valid=valid)
    np.savez_compressed(OUT, **data)
    print(f"wrote {OUT}: cold iters {data['cold_iters']}, "
          f"warm iters {data['warm_iters']}")


if __name__ == "__main__":
    main()
