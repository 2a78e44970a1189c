"""Single-device sparse mat-vec / mat-multivec as gather + segmented sum.

Port of ``repro.sparse.spmv``. The reference scatters with
``jax.ops.segment_sum``; torch's ``index_add_`` would do the same with
float atomics on CUDA, so results would change from run to run, and the
reference pins bit-identity in places (rank_k=0 ignoring stable_sweeps,
pipelined equal to serial, an f64 ladder equal to the single phase). Here
the edges are sorted by their target once (``segment_layout``, at plan
time in the dense backend) and summed per target with
``torch.segment_reduce``, which adds each segment in edge order on every
device: deterministic, and on the CPU the same order (and, in bf16, the
same per-add rounding) as XLA's scatter.

Vectors may be (N,) or (N, V).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class SegmentLayout:
    """Edges regrouped by target: ``gather[e']`` is the source row the
    e'-th target-sorted edge reads, ``w`` its weight (None: 1.0),
    ``lengths[t]`` the number of edges landing on row t."""

    gather: torch.Tensor   # (E,) int64
    w: Optional[torch.Tensor]
    lengths: torch.Tensor  # (n,) int64


def segment_layout(gather, target, n: int, w=None) -> SegmentLayout:
    """Stable sort of the edges by ``target`` (ties keep edge order)."""
    target = torch.as_tensor(target).long()
    order = torch.argsort(target, stable=True)
    return SegmentLayout(
        gather=torch.as_tensor(gather).long().index_select(0, order),
        w=None if w is None else w.index_select(0, order),
        lengths=torch.bincount(target, minlength=n))


def segment_sum(x, layout: SegmentLayout):
    """out[t] = sum over edges e landing on t of x[gather_e] * w_e."""
    xg = x.index_select(0, layout.gather)
    if layout.w is not None:
        xg = xg * (layout.w[:, None] if xg.dim() == 2 else layout.w)
    return torch.segment_reduce(xg, "sum", lengths=layout.lengths, axis=0)


def spmv_dst(x, src, dst, n, w=None, layout: Optional[SegmentLayout] = None):
    """out[j] = sum over edges (i->j) of x[i] * w_e (the authority update).

    ``layout`` is ``segment_layout(src, dst, n, w)`` precomputed; without
    it the sort runs on every call."""
    if layout is None:
        layout = segment_layout(src, dst, n, w)
    return segment_sum(x, layout)


def spmv_src(x, src, dst, n, w=None, layout: Optional[SegmentLayout] = None):
    """out[i] = sum over edges (i->j) of x[j] * w_e (the hub update).

    ``layout`` is ``segment_layout(dst, src, n, w)`` precomputed."""
    if layout is None:
        layout = segment_layout(dst, src, n, w)
    return segment_sum(x, layout)


def normalize_l1(x, axis=0, eps=1e-30):
    return x / (x.abs().sum(dim=axis, keepdim=x.dim() > 1) + eps)


def residual_l1(x, y, axis=0):
    d = (x - y).abs().sum(dim=axis)
    return d.max() if d.dim() else d
