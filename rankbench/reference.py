"""The plain reference the benchmark holds the program to: the paper's
accelerated HITS (Mirzal & Furukawa, Algorithm 2, eq. 2-3) in numpy,
over a whole crawl.

It takes only the edges the harness made from the seed, works out every
degree and weight itself, and imports nothing of the program.
Sums run in float64 (``np.bincount``).
"""
from __future__ import annotations

import numpy as np


def accel_weights(indeg: np.ndarray, outdeg: np.ndarray):
    """(ca, ch) of eq. 2-3: ca = indeg/deg * |indeg - outdeg|^p and
    ch = outdeg/deg * |indeg - outdeg|^-p with p = sign(indeg - outdeg);
    0 for a page without links."""
    indeg = np.asarray(indeg, np.float64)
    outdeg = np.asarray(outdeg, np.float64)
    deg = indeg + outdeg
    diff = np.abs(indeg - outdeg)
    ca = np.zeros_like(deg)
    ch = np.zeros_like(deg)
    live = deg > 0
    up = indeg > outdeg
    down = indeg < outdeg
    f = np.ones_like(deg)
    f[up] = diff[up]
    f[down] = 1.0 / diff[down]
    ca[live] = indeg[live] / deg[live] * f[live]
    ch[live] = outdeg[live] / deg[live] / f[live]
    return ca, ch


def _sweep(n, src, dst, ca, ch, h):
    """One sweep: a = L^T (h * ch), h' = L (a * ca), h' / |h'|_1."""
    a = np.bincount(dst, weights=(h * ch)[src], minlength=n)
    h_new = np.bincount(src, weights=(a * ca)[dst], minlength=n)
    return h_new / (np.abs(h_new).sum() + 1e-30), a


def crawl_ranking(n: int, src: np.ndarray, dst: np.ndarray, tol: float,
                  max_iter: int):
    """Accelerated HITS over the whole crawl from the uniform start, the
    way the whole-crawl job runs it: sweeps until the L1 change of the hub
    vector is at most ``tol``. Returns (hub, authority of the last sweep,
    L1-normalised, sweeps)."""
    ca, ch = accel_weights(np.bincount(dst, minlength=n),
                           np.bincount(src, minlength=n))
    h = np.full(n, 1.0 / n)
    a = np.zeros(n)
    k = 0
    for k in range(1, max_iter + 1):
        h_new, a = _sweep(n, src, dst, ca, ch, h)
        delta = np.abs(h_new - h).sum()
        h = h_new
        if delta <= tol:
            break
    return h, a / (np.abs(a).sum() + 1e-30), k

