"""The plan's packing and unpacking device time: the busy time (the union
of the device operations) inside each marked plan's stages but the
solver call's (`plan.pack`, `plan.unpack`: the linearizations, stage_qp,
the frame rotations and the solution's reshaping; `plan.ipm` left out),
the mean over the marked profile's plans (portbench/marked.py)."""

from portbench import marked


def read(obs):
    if obs.get("kind") != "plan":
        return None
    return (marked.observe(obs) or {}).get("plan_pack_ms")
