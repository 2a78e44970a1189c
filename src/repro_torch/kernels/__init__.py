"""Hand-written CUDA kernels for the H100 and their plain-torch versions.

bsr_spmm: block-sparse adjacency x multi-vector with fused Ca/Ch scaling
          (K1) and the convergence loop around it (K2), one CUDA graph per
          call (``K2Graph``), with its sweep-epilogue kernels.
seg_matmul: tiled segment-sum of gathered edge messages (K3), behind
          ``ops.seg_aggregate`` and GIN's aggregation ``ops.aggregate``
          (forward and backward, over ``ops.EdgeLayouts``).
ops.hits_sweep_bsr: the whole-graph accelerated-HITS sweep, K1's link
          form twice a sweep (``links_scaled_matvec`` over each 0/1
          operator's links, ``ops.link_operand``, in the graph's own order).
The kernels build at first use from ``csrc/`` (``kernels.build``); on CPU
tensors every wrapper runs its plain version. K1 and K3 compute their
pieces (blocks, tiles) in parallel and fold them in order through a
``Scratch`` (workspace and fold counters).
"""
from .build import Scratch
from .bsr_spmm import (BsrOperand, K2Graph, LinkOperand, LoopState,
                       bsr_converge_cols,
                       bsr_converge_cols_plain, bsr_scaled_matvec,
                       bsr_scaled_matvec_plain, counters,
                       links_scaled_matvec, links_scaled_matvec_plain,
                       reset_counters,
                       sweep_certificate, sweep_certificate_plain,
                       sweep_epilogue, sweep_epilogue_plain)
from .ops import (DeviceBSR, DeviceSegments, EdgeLayouts, aggregate,
                  bsr_converge, bsr_matvec, bsr_nblocks, bsr_revalue,
                  build_tiled_segments, classify_exit, hits_sweep_bsr,
                  link_operand,
                  pad_empty_rows, pad_messages, seg_aggregate, tiled_layout)
from .seg_matmul import seg_matmul, seg_matmul_plain

__all__ = [
    "BsrOperand", "K2Graph", "LoopState", "Scratch", "DeviceSegments", "bsr_converge_cols", "bsr_converge_cols_plain",
    "bsr_scaled_matvec", "bsr_scaled_matvec_plain", "counters",
    "reset_counters", "sweep_certificate", "sweep_certificate_plain",
    "sweep_epilogue", "sweep_epilogue_plain", "DeviceBSR", "bsr_converge",
    "bsr_matvec", "bsr_nblocks", "bsr_revalue", "hits_sweep_bsr", "classify_exit", "pad_empty_rows",
    "build_tiled_segments", "pad_messages", "seg_aggregate", "seg_matmul",
    "seg_matmul_plain", "EdgeLayouts", "aggregate", "tiled_layout",
    "LinkOperand", "link_operand", "links_scaled_matvec",
    "links_scaled_matvec_plain",
]
