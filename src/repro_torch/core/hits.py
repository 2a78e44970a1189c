"""Accelerated HITS sweeps (port of ``repro.core.hits``: the sweep
functions the serving backends run; ``qi_hits``/``accel_hits`` and the
power engine they run under are not ported yet).

Vectors may be multi-column (N, V) — V independent ranking vectors per
traversal.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..graph.structure import Graph
from ..runtime import resolve_device
from ..sparse.spmv import (SegmentLayout, normalize_l1, segment_layout,
                           spmv_dst, spmv_src)


@dataclasses.dataclass(frozen=True)
class EdgeList:
    """Device edge list. ``w`` is an optional per-edge weight.

    ``by_dst``/``by_src`` are the edges regrouped by target for the
    authority and hub half-steps (``sparse.spmv.segment_layout``), built
    once here so every sweep sums deterministically without re-sorting.
    """

    src: torch.Tensor
    dst: torch.Tensor
    n: int
    w: Optional[torch.Tensor] = None
    by_dst: Optional[SegmentLayout] = None
    by_src: Optional[SegmentLayout] = None

    @staticmethod
    def build(src, dst, n: int, w=None) -> "EdgeList":
        """Edge list over ``src``/``dst`` tensors (on their device) with
        both segment layouts."""
        return EdgeList(src, dst, n, w,
                        by_dst=segment_layout(src, dst, n, w),
                        by_src=segment_layout(dst, src, n, w))

    @staticmethod
    def from_graph(g: Graph, device="cuda") -> "EdgeList":
        dev = resolve_device(device)
        return EdgeList.build(torch.as_tensor(g.src, device=dev),
                              torch.as_tensor(g.dst, device=dev), g.n_nodes)

    def astype(self, dtype) -> "EdgeList":
        """The same edges with the weights cast (the ladder's bulk copy)."""
        if self.w is None:
            return self
        return EdgeList.build(self.src, self.dst, self.n, self.w.to(dtype))


def _col(d, x):
    return d[:, None] if x.dim() == 2 else d


def hits_sweep(edges: EdgeList, ca=None, ch=None, zeta: float = 1.0):
    """Build the sweep h -> (h_next_normalized, a).

    ca/ch None => Algorithm 1 (QI-HITS); tensors => Algorithm 2.
    zeta < 1 applies the §3.4 primitivity fix on the hub chain.
    """

    def sweep(h):
        hw = h if ch is None else h * _col(ch, h)
        a = spmv_dst(hw, edges.src, edges.dst, edges.n, edges.w,
                     layout=edges.by_dst)
        if zeta < 1.0:  # §3.4: smooth both half-steps (X̂ = ζX + (1-ζ)/N eeᵀ)
            a = zeta * a + (1.0 - zeta) / edges.n * h.sum(dim=0)
        aw = a if ca is None else a * _col(ca, a)
        h_new = spmv_src(aw, edges.src, edges.dst, edges.n, edges.w,
                         layout=edges.by_src)
        if zeta < 1.0:
            h_new = zeta * h_new + (1.0 - zeta) / edges.n * a.sum(dim=0)
        return normalize_l1(h_new, axis=0), a

    return sweep


def hits_sweep_cols(edges: EdgeList, ca, ch, mask):
    """Multi-query sweep: ca/ch/mask are (N, V); column j is accelerated
    HITS restricted to its own focused node set (``mask[:, j]``, with
    per-column weights induced by that set), so one edge traversal serves
    V independent query-focused rankings."""

    def sweep(h):
        a = spmv_dst(h * ch, edges.src, edges.dst, edges.n, edges.w,
                     layout=edges.by_dst) * mask
        h_new = spmv_src(a * ca, edges.src, edges.dst, edges.n, edges.w,
                         layout=edges.by_src) * mask
        return normalize_l1(h_new, axis=0), a

    return sweep
