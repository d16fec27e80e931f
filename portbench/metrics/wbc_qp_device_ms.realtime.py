"""The B=1 WBC call's QP device time: the busy time (the union of the
device operations) inside the `wbc.qp` stage of the marked profile's WBC
calls (portbench/marked.py: the traced window's rounds replayed with the
program's stage marks on), the median over the calls."""

from portbench import marked


def read(obs):
    if obs.get("kind") != "realtime":
        return None
    return (marked.observe(obs) or {}).get("wbc_qp_ms")
