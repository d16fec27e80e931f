"""The share of loaded foot-ticks on raised or tilted ground: the
window's mean of CycleMetrics.ground_feet over every lane and cycle, in a
sweep on height maps (portbench/kinds/terrain.py); nothing elsewhere."""


def read(obs):
    if obs.get("kind") != "sweep" or "worlds" not in obs:
        return None
    return 100.0 * obs["ground_feet_share"]
