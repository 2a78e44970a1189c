"""PageRank (Algorithm 3, Langville-Meyer formulation) — the paper's second
baseline. p ← α·p·Do⁻¹·L + (α·p·d + 1-α)·eᵀ/N.

Port of ``repro.core.pagerank``: the flow term is the port's deterministic
``spmv_dst`` (edges sorted by destination once, before the first sweep),
under the host-driven ``power_method``. Runs on ``device`` ("cuda" unless
the caller passes "cpu").
"""
from __future__ import annotations

import numpy as np
import torch

from ..graph.structure import Graph
from ..runtime import resolve_device, torch_dtype
from ..sparse.spmv import segment_layout, spmv_dst
from .power import PowerResult, power_method


def pagerank(g: Graph, alpha: float = 0.85, tol: float = 1e-10,
             max_iter: int = 2000, v: int = 1, dtype="float64",
             device="cuda", **kw) -> PowerResult:
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    outdeg = g.outdeg().astype(np.float64)
    inv_out = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1), 0.0)
    dangling = (outdeg == 0).astype(np.float64)
    inv_out_t = torch.from_numpy(inv_out).to(dev, dt)
    dang_t = torch.from_numpy(dangling).to(dev, dt)
    src = torch.as_tensor(g.src, device=dev)
    dst = torch.as_tensor(g.dst, device=dev)
    n = g.n_nodes
    by_dst = segment_layout(src, dst, n)

    def sweep(p):
        scaled = p * (inv_out_t[:, None] if p.dim() == 2 else inv_out_t)
        flow = spmv_dst(scaled, src, dst, n, layout=by_dst)
        dang_mass = torch.tensordot(dang_t, p, dims=([0], [0]))  # () or (V,)
        p_new = alpha * flow + (alpha * dang_mass + (1.0 - alpha)) / n
        return p_new, p_new

    shape = (n, v) if v > 1 else (n,)
    p0 = torch.full(shape, 1.0 / n, dtype=dt, device=dev)
    return power_method(sweep, p0, tol, max_iter, **kw)
