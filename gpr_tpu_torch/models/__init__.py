from .fitc import InducingState, calc_inducing
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
