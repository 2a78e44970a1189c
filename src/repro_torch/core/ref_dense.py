"""Dense fp64 numpy oracles for every ranking algorithm — the ground truth
the sparse and kernel paths are tested against. Small graphs only. A copy
of ``repro.core.ref_dense`` (pure numpy): the same values, bit for bit.
"""
from __future__ import annotations

import numpy as np

from ..graph.structure import Graph
from .weights import accel_weights


def qi_hits_dense(g: Graph, tol=1e-12, max_iter=5000):
    L = g.to_dense()
    n = g.n_nodes
    h = np.full(n, 1.0 / n)
    residuals = []
    for k in range(1, max_iter + 1):
        a = h @ L
        h_new = a @ L.T
        s = np.abs(h_new).sum()
        h_new = h_new / (s + 1e-300)
        delta = np.abs(h_new - h).sum()
        residuals.append(delta)
        h = h_new
        if delta <= tol:
            break
    a = h @ L
    a = a / (np.abs(a).sum() + 1e-300)
    return a, h, k, np.array(residuals)


def accel_hits_dense(g: Graph, tol=1e-12, max_iter=5000):
    L = g.to_dense()
    n = g.n_nodes
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    h = np.full(n, 1.0 / n)
    residuals = []
    for k in range(1, max_iter + 1):
        a = (h * ch) @ L
        h_new = (a * ca) @ L.T
        s = np.abs(h_new).sum()
        h_new = h_new / (s + 1e-300)
        delta = np.abs(h_new - h).sum()
        residuals.append(delta)
        h = h_new
        if delta <= tol:
            break
    a = (h * ch) @ L
    a = a / (np.abs(a).sum() + 1e-300)
    return a, h, k, np.array(residuals)


def pagerank_dense(g: Graph, alpha=0.85, tol=1e-12, max_iter=5000):
    L = g.to_dense()
    n = g.n_nodes
    outdeg = L.sum(axis=1)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    d = (outdeg == 0).astype(np.float64)
    p = np.full(n, 1.0 / n)
    residuals = []
    for k in range(1, max_iter + 1):
        p_new = alpha * (p * inv) @ L + (alpha * (p @ d) + 1 - alpha) / n
        delta = np.abs(p_new - p).sum()
        residuals.append(delta)
        p = p_new
        if delta <= tol:
            break
    return p, k, np.array(residuals)
