"""The training step's share of the cards' FP32 peak: the operations of
one value+grad evaluation counted from its shapes (``counts.eval_flops``,
the same whatever implements it) times the evaluations of the window, over
the window's seconds times the peak and the cards."""

import counts


def read(ev):
    if ev.get("kind") != "train" or not ev.get("evals"):
        return None
    work = ev["flops_per_eval"] * ev["evals"]
    return 100.0 * work / (ev["window_s"] * counts.PEAK_FP32 * ev["chips"])
