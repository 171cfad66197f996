"""Data-parallel training, serving and the iterative solve over a 1-D mesh
of ``torch.distributed`` ranks, and tensor parallelism over a 2-D (data x
model) mesh: the counterpart of ``gpr_tpu/parallel/`` (``sharded.py``,
``classify_sharded.py``, ``iter_sharded.py``, ``mesh2d.py``,
``dist_chol.py``).  ``spmd.run_spmd`` runs a function on every rank of a
spawned world."""

from .classify_sharded import (
    sharded_binomial_log_evidence,
    sharded_classify_log_evidence,
    sharded_classify_predict,
    sharded_ep_log_evidence,
    sharded_hetero_log_evidence,
    sharded_multiclass_log_evidence,
    sharded_negbin_log_evidence,
    sharded_ordinal_log_evidence,
    sharded_poisson_log_evidence,
    sharded_t_moments,
)
from .dist_chol import (
    dist_cholesky_upper,
    dist_log_det_tri,
    dist_solve_lower_cols,
    dist_solve_lower_t,
    dist_solve_upper_cols,
    dist_spd_inverse_cols,
    dist_transpose_cols,
    dist_whiten_cols,
    whiten_cols_replicated,
)
from .iter_sharded import sharded_iter_solve
from .mesh2d import (
    MODEL_AXIS,
    fit_sharded_2d,
    fully_distributed_predict,
    make_mesh_2d,
    sharded_log_evidence_2d,
)
from .sharded import (
    DATA_AXIS,
    fit_restarts_sharded,
    fit_sharded,
    make_mesh,
    make_sharded_objective,
    pad_to_shards,
    probe_starts_sharded,
    shard_batch,
    sharded_log_evidence,
    sharded_log_evidence_tsqr,
    sharded_pitc_log_evidence,
    sharded_predict_means,
    sharded_predict_variances,
    sharded_warped_log_evidence,
)
from .spmd import (
    AllSum,
    DataMesh,
    Mesh2D,
    run_spmd,
    sharded_grad,
    sharded_value_and_grad,
)

__all__ = [n for n in dir() if not n.startswith("_")]
