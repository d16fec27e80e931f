"""The replan's device time: CUDA events around each `planner.plan` call
of the measured window, the median."""


def read(obs):
    if obs.get("kind") != "realtime":
        return None
    return obs["replan_device_ms"]
