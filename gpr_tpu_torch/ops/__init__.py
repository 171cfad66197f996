from .fused_stats import (
    se_iso_stream_bwd_fused,
    se_iso_stream_stats_fused,
    se_iso_stream_stats_fused_acc,
)
from .gemm_chain import gemm_chain

__all__ = ["gemm_chain", "se_iso_stream_bwd_fused",
           "se_iso_stream_stats_fused", "se_iso_stream_stats_fused_acc"]
