from .fused_stats import (
    se_iso_stream_bwd_fused,
    se_iso_stream_stats_fused,
    se_iso_stream_stats_fused_acc,
)

__all__ = ["se_iso_stream_bwd_fused", "se_iso_stream_stats_fused",
           "se_iso_stream_stats_fused_acc"]
