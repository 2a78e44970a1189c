"""Aitken and Quadratic extrapolation (Kamvar et al., WWW'03) as power-method
assists — related-work accelerations the paper suggests composing with its
own (§5 future work #1). Host-side: they read the last iterates and emit a
better starting vector for the next sweep.

A copy of ``repro.core.extrapolation`` (pure numpy); ``power_method``
hands the extrapolators numpy iterates on every device.
"""
from __future__ import annotations

import numpy as np


def aitken(history) -> np.ndarray | None:
    """Aitken Δ² over the last 3 iterates (elementwise), guards small denoms."""
    if len(history) < 3:
        return None
    x0, x1, x2 = (np.asarray(h, np.float64) for h in history[-3:])
    denom = x2 - 2.0 * x1 + x0
    safe = np.abs(denom) > 1e-14
    x_star = np.where(safe, x0 - (x1 - x0) ** 2 / np.where(safe, denom, 1.0), x2)
    x_star = np.clip(x_star, 0.0, None)
    s = x_star.sum(axis=0)
    if np.any(s <= 0):
        return None
    return (x_star / s).astype(history[-1].dtype)


def quadratic(history) -> np.ndarray | None:
    """Quadratic extrapolation over the last 4 iterates.

    Assumes x ≈ u1 + β2·u2 + β3·u3 (three-eigenvector model) and eliminates
    the u2/u3 error terms with a least-squares fit.
    """
    if len(history) < 4:
        return None
    xm3, xm2, xm1, x0 = (np.asarray(h, np.float64) for h in history[-4:])
    if xm3.ndim == 2:  # multi-vector: extrapolate each column
        cols = [quadratic([xm3[:, i], xm2[:, i], xm1[:, i], x0[:, i]])
                for i in range(x0.shape[1])]
        if any(c is None for c in cols):
            return None
        return np.stack(cols, axis=1).astype(history[-1].dtype)
    y2 = xm2 - xm3
    y1 = xm1 - xm3
    y0 = x0 - xm3
    Y = np.stack([y2, y1], axis=1)              # (N, 2)
    gamma, *_ = np.linalg.lstsq(Y, -y0, rcond=None)
    g1, g2 = float(gamma[0]), float(gamma[1])
    g3 = 1.0
    b0 = g1 + g2 + g3
    b1 = g2 + g3
    b2 = g3
    x_star = b0 * xm2 + b1 * xm1 + b2 * x0
    x_star = np.clip(x_star, 0.0, None)
    s = x_star.sum()
    if not np.isfinite(s) or s <= 1e-300:
        return None
    return (x_star / s).astype(history[-1].dtype)
