"""Share of the training window in which no operation runs on the card
(rank 0's card on a mesh): the profiler timeline's union of device
operations against the window."""


def read(ev):
    tr = ev.get("trace")
    if tr is None or ev.get("kind") != "train" or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
