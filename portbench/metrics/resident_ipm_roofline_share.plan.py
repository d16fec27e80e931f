"""The resident IPM kernel's share of its roofline in the traced window:
the least time of its work (portbench/counts/resident_ipm.py, over the
iterations each lane ran) over its device time by name, against the
card's published peaks."""


def read(obs):
    if obs.get("kind") != "plan" or not obs["trace"].lossless:
        return None
    return obs.get("resident_roofline_pct")
