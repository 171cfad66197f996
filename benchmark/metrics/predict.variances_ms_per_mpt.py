"""Device milliseconds per million points of ``predict_variances_blocked``:
CUDA events around the benchmark's calls, summed over the window."""


def read(ev):
    if ev.get("kind") != "serve" or ev.get("variances_ms") is None:
        return None
    return ev["variances_ms"] / (ev["points"] / 1e6)
