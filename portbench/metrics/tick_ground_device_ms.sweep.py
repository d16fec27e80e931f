"""The ground lookups' device time a tick: the busy time (the union of the
device operations) inside the `ground` stages of the marked profile's
ticks (portbench/marked.py: the cone bases at the measured feet in
loop._tick_refs and each physics substep's height and normal lookups in
sim/physics._contact), the mean over the ticks, in a sweep on height
maps (portbench/kinds/terrain.py); nothing elsewhere."""

from portbench import marked


def read(obs):
    if obs.get("kind") != "sweep" or "worlds" not in obs:
        return None
    return (marked.observe(obs) or {}).get("tick_ground_ms")
