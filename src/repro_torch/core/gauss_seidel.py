"""Gauss-Seidel PageRank (Arasu et al., WWW'02 — paper §2 related work).

PageRank as the linear system (I − αMᵀ)p = (1−α)/N·e with M = row-stochastic
L (dangling rows replaced by the teleport distribution). One GS sweep uses
already-updated entries: split I − αMᵀ = D − L_low − U_up and solve
(D − L_low)·p⁽ᵏ⁺¹⁾ = U_up·p⁽ᵏ⁾ + b via sparse triangular substitution
(scipy; host-side — GS is inherently sequential, the reason the paper
prefers the power method at web scale, but it converges in fewer sweeps).

A copy of ``repro.core.gauss_seidel``: host scipy, as the reference has it.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..graph.structure import Graph


def pagerank_gs(g: Graph, alpha: float = 0.85, tol: float = 1e-10,
                max_iter: int = 500):
    """Linear-system formulation (Langville-Meyer, 'Deeper Inside
    PageRank'): the dangling rank-1 correction only rescales the solution
    of (I − αMᵀ)x = e/N with sub-stochastic M, so solve that system by GS
    sweeps and L1-normalize once at the end (exact, not lagged)."""
    n = g.n_nodes
    outdeg = g.outdeg().astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1.0), 0.0)
    w = inv[g.src]
    mt = sp.csr_matrix((w, (g.dst, g.src)), shape=(n, n))
    a = sp.eye(n, format="csr") - alpha * mt
    lower = sp.tril(a, format="csr")
    upper = a - lower
    b = np.full(n, 1.0 / n)
    x = b.copy()
    residuals = []
    for k in range(1, max_iter + 1):
        x_new = spla.spsolve_triangular(lower, b - upper @ x, lower=True)
        delta = np.abs(x_new - x).sum() / max(np.abs(x_new).sum(), 1e-300)
        residuals.append(delta)
        x = x_new
        if delta <= tol:
            break
    return x / x.sum(), k, np.asarray(residuals)
