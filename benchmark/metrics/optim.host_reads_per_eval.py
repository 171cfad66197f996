"""The optimizer's reads of device scalars per evaluation over the window:
``gpr.optim.host_read`` spans (``tracing.host_read``, each a wait for the
card) over ``gpr.optim.eval`` spans (rank 0's process only)."""

import spans


def read(ev):
    rec = spans.recorded(ev)
    if rec is None or ev.get("kind") != "train":
        return None
    evals = len(spans.named(rec, "gpr.optim.eval"))
    if not evals:
        return None
    return len(spans.named(rec, "gpr.optim.host_read")) / evals
