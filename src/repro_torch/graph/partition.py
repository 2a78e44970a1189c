"""Edge partitioning for distributed SpMV / message passing.

``partition_edges`` shards the COO list into equal-size chunks (padded with
masked sentinel edges) so every device holds a (E/S,) slice — the layout the
shard_map SpMV consumes. ``partition_edges_by_dst_block`` additionally sorts
edges so each shard's destinations fall in one contiguous node block, which
converts the cross-shard combine from an all-reduce over the full vector
into a reduce-scatter (the locality optimization used in §Perf).

A copy of ``repro.graph.partition`` (pure numpy): the same arrays.
"""
from __future__ import annotations

import numpy as np

from .structure import Graph


def _pad_to(x: np.ndarray, size: int, fill) -> np.ndarray:
    out = np.full(size, fill, dtype=x.dtype)
    out[: x.shape[0]] = x
    return out


def partition_edges(g: Graph, n_shards: int, weights: np.ndarray | None = None):
    """Round-robin balanced edge shards.

    Returns dict of arrays shaped (n_shards, E_pad): src, dst, w, mask.
    Sentinel edges point at node 0 with weight 0 (mask False).
    """
    e = g.n_edges
    e_pad = -(-e // n_shards) * n_shards
    per = e_pad // n_shards
    src = _pad_to(g.src, e_pad, 0).reshape(n_shards, per)
    dst = _pad_to(g.dst, e_pad, 0).reshape(n_shards, per)
    w_full = weights if weights is not None else np.ones(e, np.float32)
    w = _pad_to(w_full.astype(np.float32), e_pad, 0.0).reshape(n_shards, per)
    mask = _pad_to(np.ones(e, bool), e_pad, False).reshape(n_shards, per)
    return {"src": src, "dst": dst, "w": w, "mask": mask}


def partition_edges_by_dst_block(g: Graph, n_shards: int,
                                 weights: np.ndarray | None = None):
    """Shard edges by destination block: shard s owns destinations in
    [s*ceil(N/S), (s+1)*ceil(N/S)). Partial sums then live entirely on the
    owner shard — no cross-device combine for the dst vector (outputs are
    naturally reduce-scattered)."""
    n_block = -(-g.n_nodes // n_shards)
    shard_of_edge = g.dst // n_block
    order = np.argsort(shard_of_edge, kind="stable")
    counts = np.bincount(shard_of_edge, minlength=n_shards)
    per = int(counts.max()) if counts.size else 1
    src = np.zeros((n_shards, per), np.int32)
    dst = np.zeros((n_shards, per), np.int32)
    w = np.zeros((n_shards, per), np.float32)
    mask = np.zeros((n_shards, per), bool)
    w_full = weights if weights is not None else np.ones(g.n_edges, np.float32)
    start = 0
    for s in range(n_shards):
        c = int(counts[s])
        sel = order[start:start + c]
        src[s, :c] = g.src[sel]
        dst[s, :c] = g.dst[sel]
        w[s, :c] = w_full[sel]
        mask[s, :c] = True
        start += c
    return {"src": src, "dst": dst, "w": w, "mask": mask,
            "n_block": n_block, "imbalance": per * n_shards / max(g.n_edges, 1)}
