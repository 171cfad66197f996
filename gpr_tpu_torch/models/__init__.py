from .fitc import (
    InducingState,
    ModelState,
    TrainedState,
    calc_inducing,
    calc_means,
    calc_model,
    calc_trained,
    co_variance_coeffs,
    log_evidence,
    update_sigma2,
)
from .streaming import (
    StreamingTrained,
    StreamStats,
    predict_means_blocked,
    predict_variances_blocked,
    stream_stats,
    streaming_coeffs,
    streaming_log_evidence,
    streaming_trained,
)

__all__ = [n for n in dir() if not n.startswith("_")]
