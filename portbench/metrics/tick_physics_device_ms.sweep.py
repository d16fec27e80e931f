"""Physics' device time a tick: the busy time (the union of the device
operations) inside the `physics` stage of the marked profile's ticks
(portbench/marked.py: the disturbance's evaluation and sim/physics.step,
from the end of its mark to the start of the next), the mean over the
ticks."""

from portbench import marked


def read(obs):
    if obs.get("kind") != "sweep":
        return None
    return (marked.observe(obs) or {}).get("tick_physics_ms")
