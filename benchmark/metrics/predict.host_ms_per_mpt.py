"""Host milliseconds per million points of the two predictors: for each of
``gpr.predict.means`` and ``gpr.predict.variances``, its spans' summed
milliseconds over their points / 10^6, the two added (what the calls hold
the host, beside the device's ``predict.*_ms_per_mpt``)."""

import spans


def read(ev):
    rec = spans.recorded(ev)
    if rec is None or ev.get("kind") != "serve":
        return None
    out = None
    for name in ("gpr.predict.means", "gpr.predict.variances"):
        calls = spans.named(rec, name)
        points = sum(s.fields["points"] for s in calls)
        if points:
            out = (out or 0.0) + spans.total_ms(calls, name) / (points / 1e6)
    return out
