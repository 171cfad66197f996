"""Resumable training: the optimizer state checkpointed beside the model.
The counterpart of ``gpr_tpu/io/resume.py``.

A training checkpoint is the packed hyper vector plus the L-BFGS curvature
history, so an interrupted run continues with the quasi-Newton memory it
stopped with (the reference cannot resume: SURVEY.md section 5).  The npz
keys and dtypes are the JAX package's, so a checkpoint written by either
package resumes in the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..optim.lbfgs import LBFGSHostState
from ..optim.lbfgs_device import LBFGSDeviceState, minimize_lbfgs_device


def _atomic_savez(path: str, arrays: dict) -> None:
    """Write through a temporary file and rename: a crash mid-write must not
    corrupt the only copy, which exists precisely for the crash."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Host train() loop (optim.train / optim.lbfgs.minimize_lbfgs)
# ---------------------------------------------------------------------------


def save_train_checkpoint(path: str, st: LBFGSHostState, *, best_x=None,
                          best_le=None):
    """Persist the host L-BFGS state (and the best model so far) as a plain
    npz.  Resuming with :func:`load_train_checkpoint` on the SAME objective
    reproduces the uninterrupted trajectory exactly."""
    k = len(st.s_hist)
    n = st.x.shape[0]
    _atomic_savez(path, {
        "x": np.asarray(st.x, np.float64),
        "f": np.asarray(st.f, np.float64),
        "g": np.asarray(st.g, np.float64),
        "s_hist": np.stack(st.s_hist) if k else np.zeros((0, n)),
        "y_hist": np.stack(st.y_hist) if k else np.zeros((0, n)),
        "rho_hist": np.asarray(st.rho_hist, np.float64),
        "n_iter": np.asarray(st.n_iter, np.int64),
        "best_x": np.asarray(best_x if best_x is not None else st.x,
                             np.float64),
        "best_le": np.asarray(best_le if best_le is not None else -st.f,
                              np.float64),
    })


def load_train_checkpoint(path: str):
    """Returns (LBFGSHostState, best_x, best_le)."""
    with np.load(path) as z:
        st = LBFGSHostState(
            x=z["x"],
            f=float(z["f"]),
            g=z["g"],
            s_hist=list(z["s_hist"]),
            y_hist=list(z["y_hist"]),
            rho_hist=[float(r) for r in z["rho_hist"]],
            n_iter=int(z["n_iter"]),
        )
        return st, z["best_x"], float(z["best_le"])


# ---------------------------------------------------------------------------
# Device fit() loop (optim.lbfgs_device)
# ---------------------------------------------------------------------------


def training_state_arrays(st: LBFGSDeviceState) -> dict[str, np.ndarray]:
    """Flatten an LBFGSDeviceState for ``io.checkpoint.save_model``'s
    ``extra_arrays``; the counters are int32, as the JAX state's."""

    def host(t):
        return t.detach().cpu().numpy()

    return {
        "lbfgs_x": host(st.x),
        "lbfgs_f": host(st.f),
        "lbfgs_g": host(st.g),
        "lbfgs_s_hist": host(st.s_hist),
        "lbfgs_y_hist": host(st.y_hist),
        "lbfgs_rho": host(st.rho),
        "lbfgs_head": np.asarray(st.head, np.int32),
        "lbfgs_n_iter": np.asarray(st.n_iter, np.int32),
        "lbfgs_n_evals": np.asarray(st.n_evals, np.int32),
    }


def training_state_from_arrays(extra: dict, *,
                               device="cuda") -> LBFGSDeviceState:
    """Rebuild the optimizer state saved by :func:`training_state_arrays`,
    on ``device`` (the card unless the caller asks for the CPU)."""

    def dev(name):
        return torch.tensor(np.asarray(extra[name]), device=device)

    return LBFGSDeviceState(
        x=dev("lbfgs_x"), f=dev("lbfgs_f"), g=dev("lbfgs_g"),
        s_hist=dev("lbfgs_s_hist"), y_hist=dev("lbfgs_y_hist"),
        rho=dev("lbfgs_rho"),
        head=int(extra["lbfgs_head"]),
        n_iter=int(extra["lbfgs_n_iter"]),
        failed=False,
        # absent in checkpoints written before the evaluation counter
        n_evals=int(extra.get("lbfgs_n_evals", 0)),
    )


def save_device_checkpoint(path: str, st: LBFGSDeviceState):
    """Persist a device L-BFGS state as a standalone npz (atomic replace,
    as :func:`save_train_checkpoint`); pass it as ``fit``'s
    ``state_callback``."""
    _atomic_savez(path, training_state_arrays(st))


def load_device_checkpoint(path: str, *, device="cuda") -> LBFGSDeviceState:
    """Rebuild the state saved by :func:`save_device_checkpoint`."""
    with np.load(path) as z:
        return training_state_from_arrays({k: z[k] for k in z.files},
                                          device=device)


def resume_minimize(fg, st: LBFGSDeviceState, **kw):
    """Continue a device L-BFGS run from a restored state: x, gradient and
    curvature history (``minimize_lbfgs_device``'s ``init_state``), so no
    line search is lost.  ``max_iter`` counts the original run's iterations
    too.  ``history`` comes from the saved buffers (a mismatched override
    would scramble the circular-buffer indexing)."""
    kw.setdefault("history", int(st.s_hist.shape[0]))
    if kw["history"] != int(st.s_hist.shape[0]):
        raise ValueError(
            f"history={kw['history']} does not match the checkpointed "
            f"curvature buffers ({int(st.s_hist.shape[0])})"
        )
    return minimize_lbfgs_device(fg, st.x, init_state=st._replace(
        failed=False), **kw)
