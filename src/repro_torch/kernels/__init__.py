"""Hand-written CUDA kernels for the H100 and their plain-torch versions.

bsr_spmm: block-sparse adjacency x multi-vector with fused Ca/Ch scaling
          (K1) and the on-device convergence loop around it (K2) with its
          sweep-epilogue kernel.
The kernels build at first use from ``csrc/`` (``kernels.build``); on CPU
tensors every wrapper runs its plain version.
"""
from .bsr_spmm import (BsrOperand, LoopState, bsr_converge_cols,
                       bsr_converge_cols_plain, bsr_scaled_matvec,
                       bsr_scaled_matvec_plain, counters, reset_counters,
                       sweep_certificate, sweep_certificate_plain,
                       sweep_epilogue, sweep_epilogue_plain)
from .ops import (DeviceBSR, bsr_converge, bsr_matvec, bsr_revalue,
                  classify_exit, pad_empty_rows)

__all__ = [
    "BsrOperand", "LoopState", "bsr_converge_cols", "bsr_converge_cols_plain",
    "bsr_scaled_matvec", "bsr_scaled_matvec_plain", "counters",
    "reset_counters", "sweep_certificate", "sweep_certificate_plain",
    "sweep_epilogue", "sweep_epilogue_plain", "DeviceBSR", "bsr_converge",
    "bsr_matvec", "bsr_revalue", "classify_exit", "pad_empty_rows",
]
