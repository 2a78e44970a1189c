"""Similarity / agreement metrics used by the paper (Tables 1, 8, 9-10).

A copy of ``repro.core.metrics`` (the JAX package's reference, pure
numpy): every function returns exactly what the reference returns."""
from __future__ import annotations

import numpy as np


def cosine(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    nx, ny = np.linalg.norm(x), np.linalg.norm(y)
    if nx == 0 or ny == 0:
        return 0.0
    return float(np.dot(x, y) / (nx * ny))


def _rank(x: np.ndarray) -> np.ndarray:
    """Average ranks with tie handling (midrank)."""
    order = np.argsort(x, kind="stable")
    ranks = np.empty_like(order, np.float64)
    ranks[order] = np.arange(len(x), dtype=np.float64)
    # midrank ties
    sx = x[order]
    i = 0
    while i < len(sx):
        j = i
        while j + 1 < len(sx) and sx[j + 1] == sx[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j)
        i = j + 1
    return ranks


def spearman(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64).ravel()
    y = np.asarray(y, np.float64).ravel()
    rx, ry = _rank(x), _rank(y)
    rx -= rx.mean()
    ry -= ry.mean()
    denom = np.sqrt((rx ** 2).sum() * (ry ** 2).sum())
    if denom == 0:
        return 1.0 if np.allclose(x, x[0]) and np.allclose(y, y[0]) else 0.0
    return float((rx * ry).sum() / denom)


def topk(scores: np.ndarray, k: int = 10) -> np.ndarray:
    return np.argsort(-np.asarray(scores))[:k]


def topk_overlap(x: np.ndarray, y: np.ndarray, k: int = 10) -> float:
    a, b = set(topk(x, k).tolist()), set(topk(y, k).tolist())
    return len(a & b) / k


def l1_residual(x: np.ndarray, y: np.ndarray) -> float:
    return float(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64)).sum())
