"""The share of WBC solves that converged: CycleMetrics.qp_converged over
every lane and cycle of the measured window (useful solves over those
attempted)."""


def read(obs):
    if obs.get("kind") != "sweep":
        return None
    return 100.0 * obs["qp_converged_share"]
