"""The L-BFGS's own host milliseconds per evaluation: the ``gpr.optim.iter``
spans (one iteration's direction, line search and history update) less the
``gpr.optim.eval`` and ``gpr.optim.host_read`` spans beneath them, over the
``gpr.optim.eval`` spans of the window."""

import spans


def read(ev):
    rec = spans.recorded(ev)
    if rec is None or ev.get("kind") != "train":
        return None
    evals = len(spans.named(rec, "gpr.optim.eval"))
    if not evals or not spans.named(rec, "gpr.optim.iter"):
        return None
    return spans.less_ms(rec, "gpr.optim.iter", "gpr.optim.eval",
                         "gpr.optim.host_read") / evals
