"""The WBC tick's device time: CUDA events around each `wbc.solve` call
of the measured window (its input copies, the replay and the output
clones), the median."""


def read(obs):
    if obs.get("kind") != "realtime":
        return None
    return obs["wbc_device_ms"]
