"""Dangling-page reordering adapted from PageRank (Langville-Meyer 2006) to
HITS — a beyond-paper optimization (port of ``repro.core.reordering``).

Observation: hub scores of dangling pages are identically zero (no
out-edges), and every edge source is non-dangling. The hub chain
h ← (a·Ca)·Lᵀ therefore lives entirely on the N_nd non-dangling pages. We
relabel sources into a compact [0, N_nd) space and iterate an (N_nd,)-sized
hub vector; authority stays (N,). With the paper's ~93 % dangling fractions
this cuts every O(N) vector op (scale, normalize, residual) by >10x while
keeping the same per-edge cost — and returns the same rankings.
``blocking_permutation`` applies the same observation to the BSR layout.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.structure import Graph
from ..runtime import resolve_device, torch_dtype
from ..sparse.spmv import normalize_l1, segment_layout, spmv_dst, spmv_src
from .power import PowerResult, power_method
from .weights import accel_weights


def blocking_permutation(src: np.ndarray, dst: np.ndarray,
                         n: int) -> np.ndarray:
    """Node order that clusters structural nonzeros for BSR blocking.

    Dangling pages touch no hub chain, so ordering non-dangling pages first
    — each group by total degree descending — concentrates edges into the
    leading (bs x bs) blocks and leaves the dangling tail as all-zero block
    rows the BSR simply never stores. Returns ``perm`` with
    ``perm[new_id] = old_id`` (deterministic: ties break by original id).
    """
    outdeg = np.bincount(src, minlength=n)
    indeg = np.bincount(dst, minlength=n)
    dangling = outdeg == 0
    # lexsort: last key is primary — non-dangling first, then degree desc
    return np.lexsort((np.arange(n), -(indeg + outdeg),
                       dangling)).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class CompactedGraph:
    n: int               # total pages
    n_nd: int            # non-dangling pages
    src_c: torch.Tensor  # (E,) edge sources in compact hub space
    dst: torch.Tensor    # (E,) edge destinations in full space
    nd_ids: np.ndarray   # (N_nd,) original ids of compact slots


def compact_nondangling(g: Graph, device="cuda") -> CompactedGraph:
    dang = g.dangling_mask()
    nd_ids = np.nonzero(~dang)[0].astype(np.int32)
    remap = np.full(g.n_nodes, -1, np.int32)
    remap[nd_ids] = np.arange(len(nd_ids), dtype=np.int32)
    src_c = remap[g.src]
    if not (src_c >= 0).all():
        raise ValueError("edge with dangling source cannot exist")
    dev = resolve_device(device)
    return CompactedGraph(g.n_nodes, len(nd_ids),
                          torch.from_numpy(src_c).to(dev),
                          torch.as_tensor(g.dst, device=dev), nd_ids)


def hits_reordered(g: Graph, accelerate: bool = False, tol=1e-10,
                   max_iter=2000, dtype="float64", device="cuda",
                   **kw) -> PowerResult:
    """QI-HITS / accelerated HITS on the compacted hub space.

    Returns hub (compact, expanded back to N on exit) and authority (N,).
    """
    cg = compact_nondangling(g, device)
    dev = cg.dst.device
    dt = torch_dtype(dtype)
    if accelerate:
        ca_np, ch_np = accel_weights(g.indeg(), g.outdeg())
        ca = torch.from_numpy(ca_np).to(dev, dt)                  # (N,)
        ch_c = torch.from_numpy(ch_np[cg.nd_ids]).to(dev, dt)     # (N_nd,)
    else:
        ca = None
        ch_c = None
    by_dst = segment_layout(cg.src_c, cg.dst, cg.n)
    by_src = segment_layout(cg.dst, cg.src_c, cg.n_nd)

    def sweep(h_c):
        hw = h_c if ch_c is None else h_c * ch_c
        a = spmv_dst(hw, cg.src_c, cg.dst, cg.n, layout=by_dst)         # (N,)
        aw = a if ca is None else a * ca
        h_new = spmv_src(aw, cg.src_c, cg.dst, cg.n_nd, layout=by_src)  # (N_nd,)
        return normalize_l1(h_new), a

    h0 = torch.full((cg.n_nd,), 1.0 / cg.n, dtype=dt, device=dev)
    res = power_method(sweep, h0, tol, max_iter, **kw)
    # expand hub back to full space; recompute + normalize authority
    h_full = np.zeros(cg.n, res.v.dtype)
    h_full[cg.nd_ids] = res.v / max(res.v.sum(), 1e-300)
    hv = torch.from_numpy(res.v).to(dev)
    hw = hv if ch_c is None else hv * ch_c
    a = spmv_dst(hw, cg.src_c, cg.dst, cg.n, layout=by_dst)
    res.aux = normalize_l1(a).cpu().numpy()
    res.v = h_full
    return res
