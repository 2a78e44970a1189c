"""Edge-delta classification and application for live graph mutation
(port of ``repro.serve.delta``; numpy host code).

``RankService.apply_edge_delta`` takes an operator's edge changeset —
adds, removes, reweights — and rolls it into a running service without a
restart. This module owns the graph-side half of that: normalizing and
validating the changeset, classifying it (weight-only vs structural),
and producing the post-delta edge list + edge-weight table. The
service-side half (cache invalidation, plan patch-vs-replan, spill
generation bump, warm-table carryover) lives in ``rank_service.py``.

Classification drives how much cached state survives:

* **weight-only** (reweights, no adds/removes) — every union subgraph
  keeps its topology, so every cached plan's *layout* survives; backends
  patch edge-value arrays / BSR block values in place
  (``SweepBackend.patch``, probed lazily at the next plan lookup via the
  weight-blind ``plans.topology_key``).
* **structural** (any add or remove) — the service's extractor rebuilds,
  but plans are content-keyed: union subgraphs the delta doesn't touch
  produce byte-identical padded edge arrays, so their plans (and cached
  vectors outside the touched node set) keep hitting. Only affected
  plans rebuild.

In both cases the warm table carries over: the paper's premise is that
pre-delta fixed points are excellent warm starts, so post-delta
refreshes converge in a handful of sweeps instead of from uniform.

Weight rules: weights must be finite and nonzero. A reweight to 0 is a
remove (and a zero-weight add is just a remove of nothing) — routing
them through ``removes`` keeps "edge exists" equivalent to "edge has
nonzero weight", which is what lets the BSR patch path trust that a
surviving topology keeps the same retained-edge set. Adding a pair that
already exists is treated as a reweight (idempotent rolls); removing or
reweighting a pair that doesn't exist raises (operator typo, not a
no-op).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Tuple

import numpy as np

from ..graph.structure import Graph

# (sorted unique int64 src*n+dst keys, aligned float64 weights): the
# service's edge-weight table. None means "no delta ever applied" — every
# weight is 1.0 and assemble skips the lookup entirely.
EdgeTable = Tuple[np.ndarray, np.ndarray]


def _pairs(spec, n_nodes: int, what: str, with_w: bool,
           require_w: bool = False):
    """Normalize one changeset field to ((k,2) int64 pairs, (k,) f64 w)."""
    if spec is None:
        e = np.zeros((0, 2), np.int64)
        return e, np.zeros(0, np.float64)
    rows = list(spec)
    pairs = np.zeros((len(rows), 2), np.int64)
    w = np.ones(len(rows), np.float64)
    for i, row in enumerate(rows):
        row = tuple(row)
        if len(row) == 2 and not require_w:
            s, d = row
        elif len(row) == 3 and with_w:
            s, d, w[i] = row
        else:
            want = ("(src, dst, w)" if require_w
                    else f"(src, dst{', w' if with_w else ''})")
            raise ValueError(f"{what}[{i}]: want {want}, got {row!r}")
        pairs[i] = (int(s), int(d))
    if len(rows):
        if pairs.min() < 0 or pairs.max() >= n_nodes:
            raise ValueError(f"{what}: node id outside [0, {n_nodes})")
        if with_w and (~np.isfinite(w) | (w == 0)).any():
            raise ValueError(
                f"{what}: weights must be finite and nonzero "
                "(a reweight to 0 is a remove — use removes)")
    return pairs, w


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """A normalized edge changeset against an n_nodes-node graph.

    ``adds``/``removes``/``reweights`` are (k, 2) int64 (src, dst) pair
    arrays; ``add_w``/``rw_w`` the aligned weights. Node ids are already
    range-checked; weights finite and nonzero. Deltas change *edges*
    only — the node-id space is fixed at service construction (warm
    tables, caches, and spilled vectors are all indexed by it).
    """

    adds: np.ndarray
    add_w: np.ndarray
    removes: np.ndarray
    reweights: np.ndarray
    rw_w: np.ndarray

    @staticmethod
    def normalize(adds: Optional[Iterable] = None,
                  removes: Optional[Iterable] = None,
                  reweights: Optional[Iterable] = None,
                  n_nodes: int = 0) -> "EdgeDelta":
        a, aw = _pairs(adds, n_nodes, "adds", with_w=True)
        r, _ = _pairs(removes, n_nodes, "removes", with_w=False)
        rw, rww = _pairs(reweights, n_nodes, "reweights", with_w=True,
                         require_w=True)
        return EdgeDelta(a, aw, r, rw, rww)

    @property
    def empty(self) -> bool:
        return not (len(self.adds) or len(self.removes)
                    or len(self.reweights))

    @property
    def structural(self) -> bool:
        """Does the delta change topology (vs edge values only)?"""
        return bool(len(self.adds) or len(self.removes))

    def touched_nodes(self) -> np.ndarray:
        """Sorted unique endpoints of every changed edge — the node set
        whose cached results the service must invalidate (any union
        subgraph containing one of these may rank differently)."""
        return np.unique(np.concatenate(
            [self.adds.ravel(), self.removes.ravel(),
             self.reweights.ravel()]))


def _table_of(g: Graph, table: Optional[EdgeTable]) -> EdgeTable:
    """The service's current weight table, materialized (all-1.0 when no
    delta has ever run)."""
    if table is not None:
        return table
    keys = np.unique(g.src.astype(np.int64) * g.n_nodes + g.dst)
    return keys, np.ones(len(keys), np.float64)


def apply_to_graph(g: Graph, table: Optional[EdgeTable],
                   delta: EdgeDelta) -> Tuple[Graph, EdgeTable]:
    """The post-delta (graph, edge-weight table) pair.

    Pure: neither input is mutated — the caller swaps both under its own
    lock. Weights are keyed per (src, dst) pair; duplicate edges in the
    underlying graph share their pair's weight, mirroring the unweighted
    behavior where each duplicate contributes 1.0. Raises ValueError on
    removes/reweights of absent pairs and adds handled per the module
    rules above.
    """
    n = g.n_nodes
    src = np.asarray(g.src)
    dst = np.asarray(g.dst)
    gkeys = src.astype(np.int64) * n + dst
    tkeys, tvals = _table_of(g, table)
    tkeys, tvals = tkeys.copy(), tvals.copy()

    if len(delta.removes):
        rk = np.unique(delta.removes[:, 0] * n + delta.removes[:, 1])
        missing = rk[~np.isin(rk, tkeys)]
        if missing.size:
            raise ValueError(
                f"removes: {missing.size} pair(s) not in the graph "
                f"(first: ({missing[0] // n}, {missing[0] % n}))")
        keep = ~np.isin(gkeys, rk)
        src, dst, gkeys = src[keep], dst[keep], gkeys[keep]
        keep_t = ~np.isin(tkeys, rk)
        tkeys, tvals = tkeys[keep_t], tvals[keep_t]

    if len(delta.adds):
        ak = delta.adds[:, 0] * n + delta.adds[:, 1]
        # last occurrence wins within one changeset
        ak, last = np.unique(ak[::-1], return_index=True)
        aw = delta.add_w[::-1][last]
        exists = np.isin(ak, tkeys)
        # adding an existing pair == reweighting it (idempotent rolls)
        pos = np.searchsorted(tkeys, ak[exists])
        tvals[pos] = aw[exists]
        new_k, new_w = ak[~exists], aw[~exists]
        if new_k.size:
            src = np.concatenate([src, (new_k // n).astype(src.dtype)])
            dst = np.concatenate([dst, (new_k % n).astype(dst.dtype)])
            tkeys = np.concatenate([tkeys, new_k])
            tvals = np.concatenate([tvals, new_w])
            order = np.argsort(tkeys)
            tkeys, tvals = tkeys[order], tvals[order]

    if len(delta.reweights):
        wk = delta.reweights[:, 0] * n + delta.reweights[:, 1]
        pos = np.minimum(np.searchsorted(tkeys, wk), max(len(tkeys) - 1, 0))
        bad = wk[tkeys[pos] != wk] if len(tkeys) else wk
        if bad.size:
            raise ValueError(
                f"reweights: {bad.size} pair(s) not in the graph "
                f"(first: ({bad[0] // n}, {bad[0] % n}))")
        tvals[pos] = delta.rw_w

    return Graph(n, src, dst), (tkeys, tvals)


def lookup_weights(table: Optional[EdgeTable], n_nodes: int,
                   gsrc: np.ndarray, gdst: np.ndarray) -> Optional[np.ndarray]:
    """Per-edge weights for edges given by *global* endpoint arrays, or
    None when no table exists (every weight is 1.0). Every queried edge
    must be in the table — serving only ever looks up edges induced from
    the graph the table was built against."""
    if table is None:
        return None
    keys, vals = table
    gk = gsrc.astype(np.int64) * n_nodes + gdst
    pos = np.searchsorted(keys, gk)
    return vals[pos]
