"""NCCL's device time per evaluation on rank 0: the trace's operations
named ``nccl*`` over the window's evaluations."""

from harness import kernel_stats


def read(ev):
    tr = ev.get("trace")
    if tr is None or ev.get("kind") != "train" or not ev.get("evals"):
        return None
    secs, launches = kernel_stats(tr["by_name"], "nccl")
    if not launches:
        return None
    return 1e3 * secs / ev["evals"]
