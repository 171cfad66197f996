"""The optimizer's evaluations per L-BFGS iteration over the window:
``LBFGSDeviceState.n_evals`` and ``n_iter`` summed over the window's
chunks (rank 0's on a mesh, where every rank takes the same steps)."""


def read(ev):
    if ev.get("kind") != "train" or not ev.get("iters"):
        return None
    return ev["evals"] / ev["iters"]
