"""The host's enqueue of a WBC tick (runtime/graph.call: copy in, replay,
clone out): host clock from the call to its return, before the fence,
the median over the measured window."""


def read(obs):
    if obs.get("kind") != "realtime":
        return None
    return obs["wbc_enqueue_ms"]
