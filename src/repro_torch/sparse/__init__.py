from .spmv import (SegmentLayout, normalize_l1, residual_l1, segment_layout,
                   segment_sum, spmv_dst, spmv_src)

__all__ = ["SegmentLayout", "normalize_l1", "residual_l1", "segment_layout",
           "segment_sum", "spmv_dst", "spmv_src"]
