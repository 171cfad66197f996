"""How long one evaluation's calls into the training step hold the calling
thread: the summed milliseconds of the ``gpr.step.stats``,
``gpr.step.epilogue`` and ``gpr.step.backward`` spans over the
``gpr.optim.eval`` spans of the window (launches, and the waits of the
host reads inside them)."""

import spans

STEP = ("gpr.step.stats", "gpr.step.epilogue", "gpr.step.backward")


def read(ev):
    rec = spans.recorded(ev)
    if rec is None or ev.get("kind") != "train":
        return None
    evals = len(spans.named(rec, "gpr.optim.eval"))
    if not evals or not spans.named(rec, *STEP):
        return None
    return spans.total_ms(rec, *STEP) / evals
