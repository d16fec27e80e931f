"""The WBC QP's device time a tick: the busy time (the union of the
device operations) inside the `wbc.qp` stage of the marked profile's
ticks (portbench/marked.py: from the end of its mark to the start of the
next, in a traced cycle replayed with the program's stage marks on), the
mean over the ticks."""

from portbench import marked


def read(obs):
    if obs.get("kind") != "sweep":
        return None
    return (marked.observe(obs) or {}).get("tick_qp_ms")
