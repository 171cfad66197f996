"""Device milliseconds per million points of ``predict_means_blocked``:
CUDA events around the benchmark's calls, summed over the window."""


def read(ev):
    if ev.get("kind") != "serve" or ev.get("means_ms") is None:
        return None
    return ev["means_ms"] / (ev["points"] / 1e6)
