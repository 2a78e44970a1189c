"""The paper's primary contribution: the accelerated HITS ranking engine
(port of ``repro.core``).

Exports: QI-HITS (Algorithm 1), the proposed accelerated HITS (Algorithm 2,
eq. 2-5), PageRank (Algorithm 3), back-button model (3.3), primitivity fix
(3.4 via zeta), power-method engine, extrapolation assists, and the
dangling-reordered variants (beyond-paper).
"""
from .backbutton import back_button
from .extrapolation import aitken, quadratic
from .hits import (EdgeList, accel_hits, authority_sweep, hits_sweep,
                   hits_sweep_cols, qi_hits, uniform_start)
from .metrics import cosine, l1_residual, spearman, topk, topk_overlap
from .pagerank import pagerank
from .power import PowerResult, power_method, power_method_jit
from .reordering import (blocking_permutation, compact_nondangling,
                         hits_reordered)
from .weights import accel_weights

__all__ = [
    "back_button", "aitken", "quadratic", "EdgeList", "accel_hits",
    "authority_sweep", "hits_sweep", "hits_sweep_cols", "qi_hits",
    "uniform_start", "cosine",
    "l1_residual", "spearman", "topk", "topk_overlap", "pagerank",
    "PowerResult", "power_method", "power_method_jit",
    "blocking_permutation", "compact_nondangling", "hits_reordered",
    "accel_weights",
]
