"""BlockRank-style aggregation warm start for HITS (paper §2, Kamvar'03).

The web graph has nested block structure: most links are intra-host. The
BlockRank recipe adapted to (accelerated) HITS:

1. partition pages into blocks (hosts); drop inter-block edges and solve
   the local accelerated-HITS fixed point per block (cheap, parallel —
   every block is an independent small power iteration);
2. build the blockgraph (blocks as vertices, inter-block link counts as
   weights) and solve its accelerated-HITS fixed point;
3. warm-start the full-graph iteration from
   h⁰_i = h_local(i) · h_block(B(i)).

Because power iterations converge geometrically from any positive start,
the result is exact; the win is fewer full-graph sweeps. Composes with the
paper's Ca/Ch acceleration (both are applied in step 1/2/3).

Port of ``repro.core.blockrank``: the local and blockgraph solves and the
full-graph iteration run the port's ``accel_hits``/``qi_hits`` and
``hits_sweep`` on ``device`` ("cuda" unless the caller passes "cpu");
the block bookkeeping is host numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.structure import Graph
from ..runtime import resolve_device
from .hits import EdgeList, _finalize, accel_hits, hits_sweep, qi_hits
from .power import PowerResult, power_method
from .weights import accel_weights


def _subgraph(g: Graph, nodes: np.ndarray) -> Graph:
    remap = np.full(g.n_nodes, -1, np.int64)
    remap[nodes] = np.arange(len(nodes))
    keep = (remap[g.src] >= 0) & (remap[g.dst] >= 0)
    return Graph(len(nodes), remap[g.src[keep]].astype(np.int32),
                 remap[g.dst[keep]].astype(np.int32))


def block_warm_start(g: Graph, blocks: np.ndarray, accelerate: bool = True,
                     local_tol: float = 1e-6, device="cuda") -> np.ndarray:
    """Return an h⁰ warm-start vector. ``blocks``: (N,) block id per page."""
    n_blocks = int(blocks.max()) + 1
    solver = accel_hits if accelerate else qi_hits
    h0 = np.full(g.n_nodes, 1.0 / g.n_nodes)
    # 1) local fixed points
    for b in range(n_blocks):
        nodes = np.nonzero(blocks == b)[0]
        if len(nodes) < 2:
            continue
        sub = _subgraph(g, nodes)
        if sub.n_edges == 0:
            continue
        res = solver(sub, tol=local_tol, max_iter=200, device=device)
        local = np.maximum(np.asarray(res.v, np.float64), 0.0)
        if local.sum() > 0:
            h0[nodes] = local / local.sum() * (len(nodes) / g.n_nodes)
    # 2) blockgraph fixed point
    bsrc = blocks[g.src]
    bdst = blocks[g.dst]
    inter = bsrc != bdst
    if inter.any():
        bg = Graph(n_blocks, bsrc[inter].astype(np.int32),
                   bdst[inter].astype(np.int32)).dedup()
        if bg.n_edges:
            bres = solver(bg, tol=local_tol, max_iter=200,
                          device=device)
            bh = np.maximum(np.asarray(bres.v, np.float64), 0.0)
            bh = bh / max(bh.sum(), 1e-300) * n_blocks
            # 3) weight local scores by block hub mass
            h0 = h0 * np.maximum(bh[blocks], 1e-3)
    s = h0.sum()
    return h0 / s if s > 0 else np.full(g.n_nodes, 1.0 / g.n_nodes)


def hits_blockrank(g: Graph, blocks: np.ndarray, accelerate: bool = True,
                   tol: float = 1e-10, max_iter: int = 2000,
                   device="cuda") -> PowerResult:
    """Full-graph (accelerated) HITS warm-started from the block solution."""
    dev = resolve_device(device)
    h0 = torch.from_numpy(block_warm_start(g, blocks, accelerate,
                                           device=dev)).to(dev, torch.float64)
    edges = EdgeList.from_graph(g, dev)
    if accelerate:
        ca, ch = (torch.from_numpy(x).to(dev)
                  for x in accel_weights(g.indeg(), g.outdeg()))
        res = power_method(hits_sweep(edges, ca=ca, ch=ch), h0, tol, max_iter)
        return _finalize(edges, res, ca=ca, ch=ch)
    res = power_method(hits_sweep(edges), h0, tol, max_iter)
    return _finalize(edges, res)


def host_blocks(n_nodes: int, n_hosts: int, seed: int = 0) -> np.ndarray:
    """Synthetic host assignment (contiguous ranges, power-law host sizes)."""
    rng = np.random.default_rng(seed)
    sizes = rng.zipf(1.6, size=n_hosts).astype(np.float64)
    sizes = np.maximum((sizes / sizes.sum() * n_nodes).astype(np.int64), 1)
    blocks = np.zeros(n_nodes, np.int64)
    start = 0
    for b, s in enumerate(sizes):
        if start >= n_nodes:
            break
        blocks[start:start + s] = b
        start += s
    blocks[start:] = n_hosts - 1
    return blocks
