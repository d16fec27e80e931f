"""The tick scan's device time a tick: the union of the device's
intervals while the traced cycle's tick scan runs (between two
synchronizations, inside the benchmark's span around `loop._scan_ticks`),
over the ticks it ran; the cycle's head and tail are not in it.  Left out
where either profile of the traced cycle lost launches."""


def read(obs):
    if obs.get("kind") != "sweep" or not obs["trace"].lossless:
        return None
    return obs.get("tick_device_ms")
