"""Query-focused subgraph extraction (Kleinberg-style base-set expansion).

Query-time HITS ranks a *focused* subgraph, not the whole crawl: a root set
of seed pages (e.g. text-match results) is expanded into the base set —
roots plus up to ``out_cap`` pages each root links to and up to ``in_cap``
pages linking to each root — and HITS runs on the subgraph induced by that
set. Dong et al. motivate shrinking the per-query iteration space; this
module does it structurally.

Expansion reads the padded neighbor tables of ``graph.structure``
(the same ``padded_neighbors`` the sampler builds on, over the forward and
reversed graph), so the caps are the same degree-truncation the sampler
applies. Everything is host-side numpy — extraction is preprocessing, like
the rest of ``graph.structure``.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from .structure import Graph, padded_neighbors, to_csr


def root_set_key(roots) -> str:
    """Stable content hash of a root set (order/duplicate insensitive)."""
    r = np.unique(np.asarray(roots, np.int64))
    return hashlib.sha1(r.tobytes()).hexdigest()


@dataclasses.dataclass(frozen=True)
class FocusedSubgraph:
    """Induced subgraph of a query's base set, in local ids.

    ``nodes`` maps local id -> global id (sorted ascending); ``graph`` is
    the induced edge list over local ids; ``roots_local`` indexes the root
    pages inside ``nodes``; ``key`` is the root-set hash (the serving-cache
    key — identical root sets always produce identical subgraphs).
    """

    nodes: np.ndarray        # (n_sub,) int32 global ids, sorted
    graph: Graph             # induced subgraph, local ids
    roots_local: np.ndarray  # (n_roots,) int32
    key: str

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])


class SubgraphExtractor:
    """Base-set expansion + induced-subgraph extraction over one graph.

    Builds the forward/reverse padded neighbor tables once; each query is
    then a couple of table gathers plus one CSR slice.
    """

    def __init__(self, g: Graph, out_cap: int = 32, in_cap: int = 32):
        self.g = g
        self.out_cap = out_cap
        self.in_cap = in_cap
        # host tables (expansion is host-side set algebra; no device copy)
        self._out_nbr, self._out_deg = padded_neighbors(g, out_cap)
        self._in_nbr, self._in_deg = padded_neighbors(g.reverse(), in_cap)
        csr = to_csr(g)
        self._ptr = csr.ptr
        self._cols = csr.cols

    def _neighbors(self, tbl, deg, roots) -> np.ndarray:
        rows = tbl[roots]                                  # (R, cap)
        valid = np.arange(tbl.shape[1])[None, :] < deg[roots, None]
        return rows[valid]

    def expand(self, roots) -> np.ndarray:
        """Base set: roots ∪ out-neighbors(≤out_cap) ∪ in-neighbors(≤in_cap)."""
        roots = np.unique(np.asarray(roots, np.int64)).astype(np.int32)
        fwd = self._neighbors(self._out_nbr, self._out_deg, roots)
        bwd = self._neighbors(self._in_nbr, self._in_deg, roots)
        return np.unique(np.concatenate([roots, fwd, bwd]))

    def induced_edges(self, nodes: np.ndarray):
        """Edges of ``g`` with both endpoints in sorted ``nodes``, local ids."""
        starts = self._ptr[nodes]
        lens = self._ptr[nodes + 1] - starts
        total = int(lens.sum())
        if total == 0:
            z = np.zeros(0, np.int32)
            return z, z
        # ragged CSR slice gather, vectorized
        idx = np.repeat(starts, lens) + \
            (np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens))
        dst_g = self._cols[idx]
        src_loc = np.repeat(np.arange(len(nodes), dtype=np.int32),
                            lens).astype(np.int32)
        pos = np.searchsorted(nodes, dst_g)
        keep = (pos < len(nodes)) & (nodes[np.minimum(pos, len(nodes) - 1)]
                                     == dst_g)
        return src_loc[keep], pos[keep].astype(np.int32)

    def extract(self, roots) -> FocusedSubgraph:
        roots_u = np.unique(np.asarray(roots, np.int64)).astype(np.int32)
        nodes = self.expand(roots_u)
        src_loc, dst_loc = self.induced_edges(nodes)
        return FocusedSubgraph(
            nodes=nodes.astype(np.int32),
            graph=Graph(len(nodes), src_loc, dst_loc),
            roots_local=np.searchsorted(nodes, roots_u).astype(np.int32),
            key=root_set_key(roots_u),
        )

    def extract_union(self, subs) -> FocusedSubgraph:
        """One induced subgraph covering several queries' node sets.

        The batched service iterates V queries as V columns over THIS graph;
        per-column node masks restrict each column to its own base set (see
        ``core.hits.hits_sweep_cols`` for why that equals the per-query
        induced operator).
        """
        nodes = np.unique(np.concatenate([s.nodes for s in subs]))
        src_loc, dst_loc = self.induced_edges(nodes)
        return FocusedSubgraph(
            nodes=nodes.astype(np.int32),
            graph=Graph(len(nodes), src_loc, dst_loc),
            roots_local=np.zeros(0, np.int32),
            key=root_set_key(nodes),
        )
