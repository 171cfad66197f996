"""Kernel #1 (``se_iso_stats_acc``, forward statistics) against its
roofline: ``counts.stats_bound`` at the rows one launch covers, over the
launch's mean device time in the trace (operations named
``se_iso_stats_kernel*``)."""

import counts
from harness import kernel_stats


def read(ev):
    tr = ev.get("trace")
    if tr is None:
        return None
    secs, launches = kernel_stats(tr["by_name"], "se_iso_stats_kernel")
    if not launches or not secs:
        return None
    cfg = ev["config"]
    bound_s = counts.stats_bound(ev["rows_per_launch"], cfg["d"],
                                 cfg["m"])["bound_ms"] * 1e-3
    return 100.0 * bound_s / (secs / launches)
