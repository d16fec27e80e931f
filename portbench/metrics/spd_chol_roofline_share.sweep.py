"""The SPD kernels' share of their roofline in the traced window: the
least time of their work (portbench/counts/spd_chol.py, at the shapes the
tick uses, times each kernel's launches in the trace) over their device
time by name, against the card's published peaks."""


def read(obs):
    if obs.get("kind") != "sweep" or not obs["trace"].lossless:
        return None
    return obs.get("spd_roofline_pct")
