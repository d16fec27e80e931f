"""The mean interior-point iterations the lanes ran (`sol.iters`, as
SolverStats.collect reads it), over every lane of the window's batches."""


def read(obs):
    if obs.get("kind") != "plan":
        return None
    return obs["ipm_iters_mean"]
