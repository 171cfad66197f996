"""Data-parallel training, serving and the iterative solve over a 1-D mesh
of ``torch.distributed`` ranks: the counterpart of ``gpr_tpu/parallel/``'s
1-D half (``sharded.py``, ``classify_sharded.py``, ``iter_sharded.py``).
``spmd.run_spmd`` runs a function on every rank of a spawned world."""

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
from .iter_sharded import sharded_iter_solve
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
    run_spmd,
    sharded_grad,
    sharded_value_and_grad,
)

__all__ = [n for n in dir() if not n.startswith("_")]
