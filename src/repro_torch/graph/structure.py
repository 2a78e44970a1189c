"""Graph containers: COO edge lists, CSR, padded neighbor lists, BSR blocks.

A copy of ``repro.graph.structure`` (the JAX package's reference): all
preprocessing is host-side numpy, and the device-facing arrays are plain
ndarrays that the port hands to torch at plan time.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def next_pow2(x: int) -> int:
    """Smallest power of two >= max(x, 2) — the shape-bucketing rule shared
    by the serving pads (rank_service) and the per-shard edge buckets
    (sparse.dist), so their jit caches key on the same sizes."""
    return 1 << max(int(x) - 1, 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Graph:
    """Directed graph as a COO edge list. Edges are (src -> dst)."""

    n_nodes: int
    src: np.ndarray  # int32 (E,)
    dst: np.ndarray  # int32 (E,)

    def __post_init__(self):
        assert self.src.shape == self.dst.shape
        object.__setattr__(self, "src", np.asarray(self.src, np.int32))
        object.__setattr__(self, "dst", np.asarray(self.dst, np.int32))

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    def outdeg(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n_nodes).astype(np.int64)

    def indeg(self) -> np.ndarray:
        return np.bincount(self.dst, minlength=self.n_nodes).astype(np.int64)

    def dangling_mask(self) -> np.ndarray:
        return self.outdeg() == 0

    def dangling_fraction(self) -> float:
        return float(self.dangling_mask().mean())

    def avg_degree(self) -> float:
        return self.n_edges / max(self.n_nodes, 1)

    def dedup(self) -> "Graph":
        key = self.src.astype(np.int64) * self.n_nodes + self.dst
        _, idx = np.unique(key, return_index=True)
        return Graph(self.n_nodes, self.src[idx], self.dst[idx])

    def reverse(self) -> "Graph":
        return Graph(self.n_nodes, self.dst.copy(), self.src.copy())

    def sort_by_dst(self) -> "Graph":
        order = np.argsort(self.dst, kind="stable")
        return Graph(self.n_nodes, self.src[order], self.dst[order])

    def sort_by_src(self) -> "Graph":
        order = np.argsort(self.src, kind="stable")
        return Graph(self.n_nodes, self.src[order], self.dst[order])

    def to_dense(self) -> np.ndarray:
        """Dense adjacency L with L[i, j] = 1 iff edge i->j. Small graphs only."""
        L = np.zeros((self.n_nodes, self.n_nodes), np.float64)
        L[self.src, self.dst] = 1.0
        return L


@dataclasses.dataclass(frozen=True)
class CSR:
    """Out-neighbor CSR: neighbors of i are cols[ptr[i]:ptr[i+1]]."""

    n_nodes: int
    ptr: np.ndarray   # int64 (N+1,)
    cols: np.ndarray  # int32 (E,)

    def degree(self) -> np.ndarray:
        return np.diff(self.ptr)


def to_csr(g: Graph) -> CSR:
    order = np.argsort(g.src, kind="stable")
    cols = g.dst[order]
    counts = np.bincount(g.src, minlength=g.n_nodes)
    ptr = np.zeros(g.n_nodes + 1, np.int64)
    np.cumsum(counts, out=ptr[1:])
    return CSR(g.n_nodes, ptr, cols)


def padded_neighbors(g: Graph, max_deg: Optional[int] = None):
    """(N, max_deg) int32 out-neighbor table + (N,) int32 true degrees.

    Rows with degree < max_deg are padded with the node's own id (safe for
    sampling: sampled index is clamped to degree; degree-0 rows self-loop and
    are masked downstream). Rows with degree > max_deg are truncated (degree
    clamp), which is the standard GraphSAGE-style cap.
    """
    csr = to_csr(g)
    deg = csr.degree().astype(np.int32)
    if max_deg is None:
        max_deg = int(deg.max()) if deg.size else 1
    tbl = np.tile(np.arange(g.n_nodes, dtype=np.int32)[:, None], (1, max_deg))
    if csr.cols.size:
        row = np.repeat(np.arange(g.n_nodes), deg)
        pos = np.arange(csr.cols.size) - csr.ptr[row]
        keep = pos < max_deg
        tbl[row[keep], pos[keep]] = csr.cols[keep]
    return tbl, np.minimum(deg, max_deg)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse adjacency: only nonzero (bs x bs) blocks are stored.

    blocks[k] is the dense content of block (brow[k], bcol[k]). Blocks are
    sorted by (brow, bcol); row_ptr[r]:row_ptr[r+1] indexes the blocks of
    block-row r (CSR over blocks). n_padded = n_block_rows * bs.
    """

    n_nodes: int
    bs: int
    blocks: np.ndarray   # float32 (nblocks, bs, bs)
    brow: np.ndarray     # int32 (nblocks,)
    bcol: np.ndarray     # int32 (nblocks,)
    row_ptr: np.ndarray  # int64 (n_block_rows+1,)

    @property
    def n_block_rows(self) -> int:
        return len(self.row_ptr) - 1

    @property
    def n_padded(self) -> int:
        return self.n_block_rows * self.bs

    @property
    def density(self) -> float:
        total = self.n_block_rows * ((self.n_nodes + self.bs - 1) // self.bs)
        return len(self.brow) / max(total, 1)

    def to_dense(self) -> np.ndarray:
        n = self.n_padded
        out = np.zeros((n, n), np.float32)
        for k in range(len(self.brow)):
            r, c = int(self.brow[k]) * self.bs, int(self.bcol[k]) * self.bs
            out[r:r + self.bs, c:c + self.bs] = self.blocks[k]
        return out[: self.n_nodes, : self.n_nodes]


def to_bsr(g: Graph, bs: int = 128, values: Optional[np.ndarray] = None) -> BSR:
    """Build BSR from COO. ``values`` (per-edge weights) default to 1.0.

    Block storage follows ``values.dtype`` (float32 default): float64
    weights must not quantize through an f32 intermediate — the serve
    backends promise <=1e-10 parity on weighted sweeps.
    """
    val_dtype = np.float32 if values is None else np.asarray(values).dtype
    nbr = (g.n_nodes + bs - 1) // bs
    br = g.src // bs
    bc = g.dst // bs
    bkey = br.astype(np.int64) * nbr + bc
    order = np.argsort(bkey, kind="stable")
    bkey_s = bkey[order]
    uniq, inverse_start = np.unique(bkey_s, return_index=True)
    nblocks = len(uniq)
    blocks = np.zeros((max(nblocks, 1), bs, bs), val_dtype)
    vals = values if values is not None else np.ones(g.n_edges, np.float32)
    # scatter each edge into its block
    blk_of_edge = np.searchsorted(uniq, bkey)
    lr = (g.src % bs).astype(np.int64)
    lc = (g.dst % bs).astype(np.int64)
    np.add.at(blocks, (blk_of_edge, lr, lc), vals.astype(val_dtype))
    brow = (uniq // nbr).astype(np.int32)
    bcol = (uniq % nbr).astype(np.int32)
    counts = np.bincount(brow, minlength=nbr)
    row_ptr = np.zeros(nbr + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    if nblocks == 0:
        blocks = np.zeros((0, bs, bs), val_dtype)
        brow = np.zeros(0, np.int32)
        bcol = np.zeros(0, np.int32)
    return BSR(g.n_nodes, bs, blocks, brow, bcol, row_ptr)
