"""The device's idle share in the traced window: 1 - (the union of the
device's intervals) / (the window, first to last recorded event)."""


def read(obs):
    if obs.get("kind") != "realtime" or not obs["trace"].lossless:
        return None
    return 100.0 * obs["trace"].idle_share
