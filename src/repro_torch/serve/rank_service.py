"""Query-focused HITS ranking service (port of
``repro.serve.rank_service``).

Serves per-query accelerated-HITS rankings over focused subgraphs:

1. **Focus** — each query's root set expands to a base set and induced
   subgraph (``graph.subgraph``).
2. **Batch** — up to V concurrent queries run as the V columns of ONE
   multi-vector accelerated-HITS iteration over the union subgraph
   (``core.hits.hits_sweep_cols``): per-column induced weights + masks make
   column j identical to ranking query j's own subgraph, while the edge
   traversal is shared.
3. **Cache** — converged authority/hub vectors are LRU-cached per root-set
   hash; repeat queries are served from cache, and overlapping queries
   warm-start from the last converged scores.

The convergence loop is pluggable (``serve.backends``: ``dense`` and the
BSR kernels' ``bsr``), with the rank-stability early exit (``rank_k``)
and the precision ladder (``sweep_dtype``) on both. Every batch runs
assemble → plan → sweep → publish through one ``ServePipeline``.

The service runs on ``RankServiceConfig.device`` — "cuda" unless the
caller passes "cpu". Not ported yet, and raising ``NotImplementedError``
rather than doing nothing: ``apply_edge_delta`` (live edge deltas),
``queue()`` (the async frontend) and ``spill_dir`` (the restart spill);
see ROADMAP.md Queue 1.
"""
from __future__ import annotations

import dataclasses
import threading
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.structure import Graph
from ..graph.subgraph import FocusedSubgraph, SubgraphExtractor
from ..runtime import dtype_name, resolve_device, torch_dtype
from .backends import (SweepBackend, SweepBatch, dtype_floor, make_backend,
                       resolve_sweep_dtype, select_backend)
from .plans import PlanCache, SweepPlan

NEXT_SLICE = "ROADMAP.md Queue 1 item 7 (serving periphery)"


@dataclasses.dataclass
class RankServiceConfig:
    v_max: int = 8             # queries batched per traversal (the V columns)
    out_cap: int = 32          # base-set expansion caps (per root)
    in_cap: int = 32
    tol: float = 1e-10
    max_iter: int = 1000
    # rank-stability early exit: with rank_k > 0 a column also stops once
    # its top-rank_k authority ordering has been unchanged for
    # stable_sweeps consecutive sweeps. 0 keeps exact-residual stopping.
    rank_k: int = 0
    stable_sweeps: int = 2
    cache_size: int = 512      # LRU entries (root-set hash -> scores)
    warm_min_overlap: float = 0.5  # min score coverage to warm-start
    dtype: object = "float64"  # sweep dtype: a name, torch or numpy dtype
    # precision ladder: a non-empty sweep_dtype ("bf16" | "fp32" | "f64" and
    # spellings thereof) runs the bulk of convergence sweeps at that dtype,
    # then polishes at the sweep dtype to polish_tol (None: tol). ""
    # keeps the single-phase loop.
    sweep_dtype: str = ""
    polish_tol: Optional[float] = None
    backend: str = "dense"     # dense | bsr | auto (sharded: not ported)
    bsr_block: int = 128       # bsr: block size
    bsr_fused: bool = True     # bsr: on-device convergence loop
    plan_cache_size: int = 64  # LRU of structural plans; <= 0 disables
    # plan-time lumped sweep reduction (serve.plans.lump_batch): off | on |
    # auto (only when it removes >= plans.LUMP_AUTO_MIN_RATIO of live rows)
    lumping: str = "off"
    # batches in flight: 1 = serial; >= 2 overlaps batch j's host
    # assemble/plan with batch j-1's device sweep
    pipeline_depth: int = 2
    spill_dir: Optional[str] = None  # not ported yet: must stay None
    device: str = "cuda"       # "cuda" (the card) or "cpu"


@dataclasses.dataclass
class QueryResult:
    roots: np.ndarray       # the (deduped, sorted) root set
    nodes: np.ndarray       # global ids of the focused subgraph
    authority: np.ndarray   # L1-normalized over ``nodes``
    hub: np.ndarray
    iters: int              # sweeps to convergence (0 for a cache hit)
    status: str             # "hit" | "warm" | "cold"
    key: str                # root-set hash (the cache key)
    # residual certificate: ‖sweep(h) − h‖₁ from one extra full-precision
    # sweep at the published h
    residual: Optional[float] = None

    def topk(self, k: int = 10):
        """Top-k (global node id, authority score) pairs."""
        order = np.argsort(-self.authority)[:k]
        return [(int(self.nodes[i]), float(self.authority[i]))
                for i in order]


@dataclasses.dataclass
class _CacheEntry:
    nodes: np.ndarray
    authority: np.ndarray
    hub: np.ndarray
    residual: Optional[float] = None  # certificate at converge time


class RankService:
    """Batched, cached, warm-starting query-ranking front end over one graph."""

    def __init__(self, g: Graph, config: Optional[RankServiceConfig] = None):
        self.g = g
        self.cfg = config or RankServiceConfig()
        if self.cfg.spill_dir is not None:
            raise NotImplementedError(
                f"spill_dir: the cache spill is not ported yet ({NEXT_SLICE})")
        self.device = resolve_device(self.cfg.device)
        eff = dtype_name(self.cfg.dtype)
        self._dtype = eff
        min_tol = dtype_floor(eff)
        if self.cfg.tol < min_tol:
            warnings.warn(
                f"RankService tol={self.cfg.tol:g} is below the {eff} "
                f"residual floor; clamping to {min_tol:g}", stacklevel=2)
            self.cfg = dataclasses.replace(self.cfg, tol=min_tol)
        # precision ladder: a ladder whose bulk dtype IS the sweep dtype
        # degenerates to the single-phase loop — normalize it to None so the
        # plan-cache key is the ladder-free one
        bulk = resolve_sweep_dtype(self.cfg.sweep_dtype)
        if bulk == eff:
            bulk = None
        if bulk is not None and torch.finfo(torch_dtype(bulk)).eps < \
                torch.finfo(torch_dtype(eff)).eps:
            raise ValueError(
                f"sweep_dtype {bulk} is higher precision than the sweep "
                f"dtype {eff} — the ladder's bulk phase must be the cheap "
                f"one")
        self._bulk_dtype = bulk
        polish = self.cfg.polish_tol
        if polish is None:
            polish = self.cfg.tol
        else:
            polish = float(polish)
            if polish <= 0:
                raise ValueError(f"polish_tol must be > 0, got {polish}")
            if polish < min_tol:
                warnings.warn(
                    f"polish_tol={polish:g} is below the {eff} residual "
                    f"floor; clamping to {min_tol:g}", stacklevel=2)
                polish = min_tol
        self._polish_tol = polish
        if self.cfg.backend not in ("dense", "sharded", "bsr", "auto"):
            raise ValueError(f"unknown backend {self.cfg.backend!r}")
        if self.cfg.rank_k < 0:
            raise ValueError(f"rank_k must be >= 0, got {self.cfg.rank_k}")
        if self.cfg.stable_sweeps < 1:
            raise ValueError(
                f"stable_sweeps must be >= 1, got {self.cfg.stable_sweeps}")
        if self.cfg.lumping not in ("off", "on", "auto"):
            raise ValueError(f"unknown lumping mode {self.cfg.lumping!r} "
                             f"(want off | on | auto)")
        self._lumping = None if self.cfg.lumping == "off" else self.cfg.lumping
        self.extractor = SubgraphExtractor(g, self.cfg.out_cap,
                                           self.cfg.in_cap)
        self._backends: Dict[str, SweepBackend] = {}
        self._cache: OrderedDict[str, _CacheEntry] = OrderedDict()
        self._plans = PlanCache(self.cfg.plan_cache_size)
        # last converged scores per global node — the warm-start table
        self._warm_h = np.zeros(g.n_nodes)
        self._warm_seen = np.zeros(g.n_nodes, bool)
        # guards every mutable serving structure: pipeline stages read and
        # write them from the prepare worker and the driving thread
        self._lock = threading.RLock()
        from .telemetry import LabeledView, LegacyStatsDict, MetricsRegistry
        reg = self.telemetry = MetricsRegistry()
        self.stats = LegacyStatsDict({
            "queries": reg.counter("service.queries"),
            "batches": reg.counter("service.batches"),
            "hit": reg.counter("service.cache.hit"),
            "warm": reg.counter("service.cache.warm"),
            "cold": reg.counter("service.cache.cold"),
            "sweeps": reg.counter("service.sweeps"),
            "backend_batches": LabeledView(reg, "service.backend.batches"),
            "plan_hits": reg.counter("service.plan.hits"),
            "plan_misses": reg.counter("service.plan.misses"),
            "plan_evictions": reg.counter("service.plan.evictions"),
        })
        self._m_sweep_iters = reg.histogram("service.sweep.iters")
        for reason in ("residual", "rank_stable", "max_iter"):
            reg.counter("service.exit", reason)
        if self.cfg.backend != "auto":  # auto resolves per batch
            reg.counter("service.backend.batches", self.cfg.backend)
        self._m_ladder = reg.counter("service.ladder.bulk_batches")
        reg.gauge("service.cache.entries")
        reg.gauge("service.plan_cache.entries")
        self._m_lumped_nodes = reg.counter("service.plan.lumped_nodes")
        self._m_reduction_ratio = reg.histogram(
            "service.plan.reduction_ratio")
        from .pipeline import ServePipeline
        self.pipeline = ServePipeline(self, depth=self.cfg.pipeline_depth)

    def queue(self, **kw):
        raise NotImplementedError(
            f"queue(): the async frontend is not ported yet ({NEXT_SLICE})")

    def apply_edge_delta(self, adds=None, removes=None, reweights=None):
        raise NotImplementedError(
            "apply_edge_delta: live edge deltas are not ported yet "
            "(ROADMAP.md Queue 1 item 6, serve/delta.py)")

    # -- backends ---------------------------------------------------------

    def _backend_for(self, n_union: int, e_union: int) -> SweepBackend:
        """The configured (or ``auto``-selected) sweep backend, one
        instance per kind."""
        kind = self.cfg.backend
        if kind == "auto":
            kind = select_backend(n_union, e_union, n_devices=1,
                                  cuda=self.device.type == "cuda")
        be = self._backends.get(kind)
        if be is None:
            be = make_backend(kind, bsr_block=self.cfg.bsr_block,
                              bsr_fused=self.cfg.bsr_fused,
                              device=self.device)
            self._backends[kind] = be
        return be

    def _plan_for(self, backend: SweepBackend, batch: SweepBatch) -> SweepPlan:
        """The backend's structural plan for this batch, LRU-cached by
        union-subgraph content hash (the padded edge structure itself, so a
        changed graph can never be served a stale layout)."""
        skey = batch.structure_key()
        # stopping params and the ladder join the key (a ladder plan carries
        # bulk-dtype operator copies a ladder-free plan lacks); lumped plans
        # never alias unlumped ones
        stop = (int(batch.rank_k), int(batch.stable_sweeps),
                batch.ladder_key())
        if batch.lump_key:
            stop = stop + ("lump:" + batch.lump_key,)
        key = (backend.name, backend.plan_params(), skey, stop)
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.stats["plan_hits"] += 1
                return plan
        plan = backend.plan(batch, skey)
        with self._lock:
            self._plans.put(key, plan)
            self.stats["plan_misses"] += 1
            self.stats["plan_evictions"] = self._plans.stats["evictions"]
        return plan

    # -- cache ------------------------------------------------------------

    def _cache_get_mem(self, key: str) -> Optional[_CacheEntry]:
        """LRU probe (caller holds the lock)."""
        e = self._cache.get(key)
        if e is not None:
            self._cache.move_to_end(key)
        return e

    def _cache_put(self, key: str, e: _CacheEntry):
        self._cache[key] = e
        self._cache.move_to_end(key)
        while len(self._cache) > self.cfg.cache_size:
            self._cache.popitem(last=False)

    def clear_result_cache(self):
        """Drop all converged-vector state (LRU entries, the warm-start
        table) while keeping cached plans."""
        with self._lock:
            self._cache.clear()
            self._warm_h[:] = 0.0
            self._warm_seen[:] = False

    def snapshot_stats(self) -> dict:
        """A consistent copy of the stats counters (the legacy key set)."""
        with self._lock:
            out = dict(self.stats)
            out["backend_batches"] = dict(self.stats["backend_batches"])
            return out

    def telemetry_snapshot(self) -> dict:
        """The full registry rendering; level gauges sampled here."""
        with self._lock:
            self.telemetry.gauge("service.cache.entries").set(
                len(self._cache))
            self.telemetry.gauge("service.plan_cache.entries").set(
                len(self._plans))
        return self.telemetry.snapshot()

    # -- serving ----------------------------------------------------------

    def validate_roots(self, roots: Sequence[int]) -> np.ndarray:
        """Deduped, sorted, range-checked root set.

        The range check runs on the int64 ids BEFORE the int32 downcast
        (2**32 must not wrap to node 0), and only integers and integral
        floats pass (3.7 must not truncate to node 3).
        """
        arr = np.asarray(roots)
        if arr.dtype.kind == "f":
            if not np.all(np.isfinite(arr)) or \
                    not np.array_equal(arr, np.trunc(arr)):
                raise ValueError(
                    f"root ids must be integral, got float values "
                    f"{np.asarray(arr).ravel()[:8]}")
        elif arr.dtype.kind not in "iu":
            raise ValueError(
                f"root ids must be integers, got dtype {arr.dtype}")
        roots_u = np.unique(arr.astype(np.int64))
        if len(roots_u) == 0:
            raise ValueError("empty root set")
        if roots_u[0] < 0 or roots_u[-1] >= self.g.n_nodes:
            raise ValueError(
                f"root ids must be in [0, {self.g.n_nodes}); got "
                f"[{roots_u[0]}, {roots_u[-1]}]")
        return roots_u.astype(np.int32)

    def rank(self, queries: Sequence[Sequence[int]], *,
             refresh: bool = False) -> List[QueryResult]:
        """Rank a list of root sets. Chunks of ``v_max`` queries share one
        traversal, through the staged pipeline. ``refresh`` re-iterates
        exact cache hits (warm-started) instead of serving stored scores."""
        from .pipeline import PipelineJob

        # validate everything before serving anything
        clean = [self.validate_roots(roots) for roots in queries]
        v = self.cfg.v_max
        jobs = [PipelineJob(queries=clean[i:i + v], refresh=refresh)
                for i in range(0, len(clean), v)]
        out: List[QueryResult] = []
        gen = self.pipeline.run(jobs)
        try:
            for _job, results, exc in gen:
                if exc is not None:
                    raise exc
                out.extend(results)
        finally:
            gen.close()  # unwind the prepare worker if we raised mid-run
        return out

    def _start_vector(self, fs: FocusedSubgraph, entry, m: np.ndarray,
                      loc: np.ndarray):
        """Column start vector (union-local) + its status label: the cached
        hub vector on an exact-key refresh, else the warm table when it
        covers enough of the base set, else uniform over S_j."""
        n_u = len(m)
        v = np.zeros(n_u)
        if entry is not None and len(entry.nodes) == len(fs.nodes) \
                and (entry.nodes == fs.nodes).all():
            v[loc] = entry.hub
            if v.sum() > 0:
                return v / np.abs(v).sum(), "warm"
        seen = self._warm_seen[fs.nodes]
        if seen.mean() >= self.cfg.warm_min_overlap:
            v[loc] = np.where(seen, self._warm_h[fs.nodes], 0.0)
            tot = np.abs(v).sum()
            if tot > 0:
                # unseen nodes get the mean warm mass so no page starts dead
                fill = tot / max(seen.sum(), 1)
                v[loc] = np.where(seen, v[loc], fill)
                return v / np.abs(v).sum(), "warm"
        v[:] = 0.0
        v[loc] = 1.0 / len(fs.nodes)
        return v, "cold"
