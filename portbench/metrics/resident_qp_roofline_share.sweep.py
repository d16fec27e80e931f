"""The resident QP kernel's share of its roofline in the traced window:
the least time of its work (portbench/counts/resident_qp.py: every lane
runs all the solver's iterations, at the cell's batch) over its device
time by name, against the card's published peaks."""


def read(obs):
    if obs.get("kind") != "sweep" or not obs["trace"].lossless:
        return None
    return obs.get("qp_roofline_pct")
