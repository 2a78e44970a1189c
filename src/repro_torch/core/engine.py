"""Production ranking engine: sharded power iteration with checkpointing,
bounded-staleness straggler tolerance, and elastic re-sharding (port of
``repro.core.engine``).

The engine partitions edges into ``n_shards`` virtual shards (run one
after another on one device; the combine semantics are those of a
sharded run). Per sweep each shard contributes a partial authority/hub
product; the combine is a sum, so the engine tolerates:

* **Stragglers**: a shard that misses the deadline reuses its previous
  partial (bounded staleness ``stale_limit``). Whether a shard straggles
  is drawn from ``np.random.default_rng(seed)`` in the reference's order,
  so the port makes the same decisions and counts the same
  ``stale_events``.
* **Failures/preemption**: state (h, k, the last residuals) is
  checkpointed through ``repro_torch.checkpoint``, whose files are the
  reference's: a run started by either package resumes in the other.
* **Elastic re-sharding**: edges can be repartitioned to a different shard
  count at restart; the fixed point is shard-count invariant.

Each shard's partial products run on the port's gather plus
``segment_reduce`` (``sparse.spmv``), its edges sorted by target once at
construction, so every sweep sums deterministically. Vectors live on
``device`` ("cuda" unless the caller passes "cpu").
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import checkpoint as ckpt_mod
from ..graph.partition import partition_edges
from ..graph.structure import Graph
from ..runtime import resolve_device, torch_dtype
from ..sparse.spmv import segment_layout, segment_sum
from .weights import accel_weights


@dataclasses.dataclass
class EngineResult:
    authority: np.ndarray
    hub: np.ndarray
    iters: int
    residuals: np.ndarray
    converged: bool
    stale_events: int


class RankingEngine:
    def __init__(self, g: Graph, algorithm: str = "accel", n_shards: int = 8,
                 stale_limit: int = 0, straggler_prob: float = 0.0,
                 checkpoint_dir: Optional[str] = None,
                 checkpoint_every: int = 0, dtype="float64", seed: int = 0,
                 device="cuda"):
        self.g = g
        self.n = g.n_nodes
        self.n_shards = n_shards
        self.stale_limit = stale_limit
        self.straggler_prob = straggler_prob
        self.ckpt_dir = checkpoint_dir
        self.ckpt_every = checkpoint_every
        self.dtype = torch_dtype(dtype)
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        parts = partition_edges(g, n_shards)
        # per shard: (authority layout: edges by dst, gathering h at src;
        # hub layout: edges by src, gathering a at dst), sentinel edges
        # weighted 0 as in the reference
        self.shards = []
        for s in range(n_shards):
            src = torch.from_numpy(parts["src"][s]).to(self.device)
            dst = torch.from_numpy(parts["dst"][s]).to(self.device)
            w = torch.from_numpy(parts["w"][s] * parts["mask"][s]).to(
                self.device, self.dtype)
            self.shards.append((segment_layout(src, dst, self.n, w),
                                segment_layout(dst, src, self.n, w)))
        if algorithm == "accel":
            ca, ch = accel_weights(g.indeg(), g.outdeg())
            self.ca = torch.from_numpy(ca).to(self.device, self.dtype)
            self.ch = torch.from_numpy(ch).to(self.device, self.dtype)
        elif algorithm == "hits":
            self.ca = None
            self.ch = None
        else:
            raise ValueError(algorithm)

    # ------------------------------------------------------------- internals
    def _sweep(self, h, cache_a, cache_h, staleness, force_fresh=False):
        """One sweep with per-shard straggler simulation."""
        stale_events = 0
        prob = 0.0 if force_fresh else self.straggler_prob
        hs = h if self.ch is None else h * self.ch
        partials_a = []
        for s, (by_dst, _) in enumerate(self.shards):
            straggles = (self.rng.random() < prob
                         and staleness[s] < self.stale_limit
                         and cache_a[s] is not None)
            if straggles:
                partials_a.append(cache_a[s])
                staleness[s] += 1
                stale_events += 1
            else:
                p = segment_sum(hs, by_dst)
                partials_a.append(p)
                cache_a[s] = p
                staleness[s] = 0
        a = sum(partials_a)
        as_ = a if self.ca is None else a * self.ca
        partials_h = []
        for s, (_, by_src) in enumerate(self.shards):
            straggles = (self.rng.random() < prob
                         and staleness[s] < self.stale_limit
                         and cache_h[s] is not None)
            if straggles:
                partials_h.append(cache_h[s])
                staleness[s] += 1
                stale_events += 1
            else:
                p = segment_sum(as_, by_src)
                partials_h.append(p)
                cache_h[s] = p
        h_new = sum(partials_h)
        h_new = h_new / (h_new.abs().sum() + 1e-30)
        return h_new, a, stale_events

    # ------------------------------------------------------------------ API
    def run(self, tol: float = 1e-10, max_iter: int = 1000,
            resume: bool = False) -> EngineResult:
        h = torch.full((self.n,), 1.0 / self.n, dtype=self.dtype,
                       device=self.device)
        k0 = 0
        residuals = []
        if resume and self.ckpt_dir and ckpt_mod.latest_step(self.ckpt_dir) is not None:
            state, k0, extra = ckpt_mod.restore(self.ckpt_dir,
                                                {"h": h.cpu().numpy()})
            h = torch.from_numpy(np.asarray(state["h"])).to(self.device,
                                                            self.dtype)
            residuals = list(extra.get("residuals", []))
        cache_a = [None] * self.n_shards
        cache_h = [None] * self.n_shards
        staleness = [0] * self.n_shards
        stale_total = 0
        converged = False
        a = torch.zeros_like(h)
        k = k0
        confirming = False
        for k in range(k0 + 1, max_iter + 1):
            # once the residual dips below tol, confirm with fully-fresh
            # sweeps (no stale partials) — otherwise a shard stuck on its
            # cached product can fake convergence at the wrong point
            h_new, a, ev = self._sweep(h, cache_a, cache_h, staleness,
                                       force_fresh=confirming)
            stale_total += ev
            delta = float((h_new - h).abs().sum())
            residuals.append(delta)
            h = h_new
            if self.ckpt_dir and self.ckpt_every and k % self.ckpt_every == 0:
                ckpt_mod.save(self.ckpt_dir, k, {"h": h.cpu().numpy()},
                              extra={"residuals": residuals[-20:]})
            if delta <= tol:
                if confirming or self.straggler_prob == 0.0:
                    converged = True
                    break
                confirming = True
            else:
                confirming = False
        a = a / (a.abs().sum() + 1e-30)
        return EngineResult(a.cpu().numpy(), h.cpu().numpy(), k,
                            np.asarray(residuals), converged, stale_total)
