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

The convergence loop is pluggable (``serve.backends``: ``dense``, the
mesh-``sharded`` sweep and the BSR kernels' ``bsr``), with the
rank-stability early exit (``rank_k``) and the precision ladder
(``sweep_dtype``) on each. Every batch runs
assemble → plan → sweep → publish through one ``ServePipeline``.

Live edge deltas (``apply_edge_delta``) roll adds, removes and
reweights into the running service: cached results the delta touches are
invalidated, the warm table carries over, and plans of unchanged
topologies are value-patched (``SweepBackend.patch``) instead of rebuilt.

``queue()`` puts the SLA-aware micro-batching frontend
(``serve.queue.RankQueue``) in front of the same pipeline, and a
``spill_dir`` makes the cache and the plans survive a restart
(``serve.spill``): converged vectors and plan layouts are checkpointed
next to each other, a restarted service restores its LRU and warm table,
and a plan cache miss tries the disk copy before rebuilding. The spill's
format is the JAX package's, so either package restores the other's.

The service runs on ``RankServiceConfig.device`` — "cuda" unless the
caller passes "cpu". The sharded backend runs ``shard_devices`` shards in
this one process, placed round-robin over the visible devices of that
type (``sparse.dist.make_mesh``): on the CPU, or on one card, they are
logical shards of one device.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.structure import Graph
from ..graph.subgraph import FocusedSubgraph, SubgraphExtractor
from ..runtime import dtype_name, resolve_device, torch_dtype
from .backends import (BACKENDS, SweepBackend, SweepBatch, dtype_floor,
                       make_backend, resolve_sweep_dtype, select_backend)
from .delta import EdgeDelta, apply_to_graph, lookup_weights
from .plans import PlanCache, SweepPlan, topology_key


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
    backend: str = "dense"     # dense | sharded | bsr | auto
    shard_mode: str = "dual_blocked"   # sharded: replicated | dual_blocked
    # sharded: shard count (None: every visible device of the service's
    # type); shards beyond the device count share devices round-robin
    shard_devices: Optional[int] = None
    bsr_block: int = 128       # bsr: block size
    bsr_fused: bool = True     # bsr: on-device convergence loop
    plan_cache_size: int = 64  # LRU of structural plans; <= 0 disables
    # plan-time lumped sweep reduction (serve.plans.lump_batch): off | on |
    # auto (only when it removes >= plans.LUMP_AUTO_MIN_RATIO of live rows)
    lumping: str = "off"
    # batches in flight: 1 = serial; >= 2 overlaps batch j's host
    # assemble/plan with batch j-1's device sweep
    pipeline_depth: int = 2
    # async micro-batching frontend (serve.queue.RankQueue / .queue()):
    deadline_ms: float = 5.0   # max extra latency batching may add
    queue_depth: Optional[int] = None  # max distinct pending (None: 4*v_max)
    # SLA admission: submits with priority >= shed_priority are
    # best-effort — under overload they resolve with status "shed"
    shed_priority: int = 1
    # restart-survivable cache and plan spill (serve.spill):
    spill_dir: Optional[str] = None    # None: in-process cache only
    spill_policy: str = "all"  # all: every converged entry | evict: LRU only
    # spill generation GC: newest step_* generations kept per entry
    # stream; init (and queue.drain) compacts the whole spill dir to this
    spill_keep_generations: int = 1
    device: str = "cuda"       # "cuda" (the card) or "cpu"


@dataclasses.dataclass
class QueryResult:
    roots: np.ndarray       # the (deduped, sorted) root set
    nodes: np.ndarray       # global ids of the focused subgraph
    authority: np.ndarray   # L1-normalized over ``nodes``
    hub: np.ndarray
    iters: int              # sweeps to convergence (0 for a cache hit)
    status: str             # "hit" | "warm" | "cold" | "shed" (queue only)
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
        self.device = resolve_device(self.cfg.device)
        if self.device.type == "cuda" and self.device.index is None:
            # a concrete card: the pipeline and queue threads bind to it
            # (runtime.bind_thread) instead of each thread's default
            self.device = torch.device("cuda", torch.cuda.current_device())
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
        if self.cfg.spill_policy not in ("all", "evict"):
            raise ValueError(f"unknown spill policy {self.cfg.spill_policy!r}")
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
            "plan_restored": reg.counter("service.plan.restored"),
            "plan_spilled": reg.counter("service.plan.spilled"),
            "spill_writes": reg.counter("service.spill.writes"),
            "spill_hits": reg.counter("service.spill.hits"),
            "spill_restored": reg.counter("service.spill.restored"),
            "spill_gc_removed": reg.counter("service.spill.gc_removed"),
        })
        self._m_sweep_iters = reg.histogram("service.sweep.iters")
        for reason in ("residual", "rank_stable", "max_iter"):
            reg.counter("service.exit", reason)
        if self.cfg.backend != "auto":  # auto resolves per batch
            reg.counter("service.backend.batches", self.cfg.backend)
        self._m_ladder = reg.counter("service.ladder.bulk_batches")
        self._m_spill_read = reg.histogram("service.spill.read_ms")
        self._m_spill_write = reg.histogram("service.spill.write_ms")
        reg.gauge("service.cache.entries")
        reg.gauge("service.plan_cache.entries")
        self._m_lumped_nodes = reg.counter("service.plan.lumped_nodes")
        self._m_reduction_ratio = reg.histogram(
            "service.plan.reduction_ratio")
        # live edge deltas: plans value-patched (labeled by the backend that
        # patched) vs fully replanned, result-cache entries invalidated,
        # and the swap's wall time
        for b in BACKENDS:
            reg.counter("service.delta.patched", b)
        self._m_delta_replanned = reg.counter("service.delta.replanned")
        self._m_delta_invalidated = reg.counter("service.delta.invalidated")
        self._m_delta_swap = reg.histogram("service.delta.swap_ms")
        # per-pair edge weights, None until the first delta (all 1.0: keeps
        # every pre-delta structure hash and code path bit-identical)
        self._edge_table = None
        # weight-blind plan index: topology key -> the newest full cache key
        # with that topology, so a post-reweight batch can patch the
        # predecessor plan instead of rebuilding (see _plan_for)
        self._topo_index: Dict[tuple, tuple] = {}
        self._spill = None
        self._plan_spill = None
        self._spill_pending: list = []  # deferred writes (see _drain_spill)
        self._spill_io_lock = threading.Lock()  # serializes disk writes
        if self.cfg.spill_dir is not None:
            from .spill import CacheSpill, PlanSpill
            keep = self.cfg.spill_keep_generations
            self._spill = CacheSpill(self.cfg.spill_dir,
                                     keep_generations=keep)
            self._plan_spill = PlanSpill(self.cfg.spill_dir,
                                         keep_generations=keep)
            self._restore_spilled()
            self.gc_spill()  # compact stale generations + crash droppings
        from .pipeline import ServePipeline
        self.pipeline = ServePipeline(self, depth=self.cfg.pipeline_depth)

    def queue(self, **kw):
        """An async micro-batching frontend over this service (the config's
        ``deadline_ms``/``queue_depth``/``shed_priority`` unless
        overridden)."""
        from .queue import RankQueue
        kw.setdefault("deadline_ms", self.cfg.deadline_ms)
        # 0 and None both mean "the 4*v_max default" (configs use 0)
        kw.setdefault("max_pending", self.cfg.queue_depth or None)
        kw.setdefault("shed_priority", self.cfg.shed_priority)
        return RankQueue(self, **kw)

    # -- backends ---------------------------------------------------------

    def _backend_for(self, n_union: int, e_union: int) -> SweepBackend:
        """The configured (or ``auto``-selected) sweep backend, one
        instance per kind."""
        kind = self.cfg.backend
        if kind == "auto":
            kind = select_backend(n_union, e_union,
                                  n_devices=self.cfg.shard_devices,
                                  cuda=self.device.type == "cuda")
        be = self._backends.get(kind)
        if be is None:
            be = make_backend(kind, shard_mode=self.cfg.shard_mode,
                              shard_devices=self.cfg.shard_devices,
                              bsr_block=self.cfg.bsr_block,
                              bsr_fused=self.cfg.bsr_fused,
                              device=self.device)
            self._backends[kind] = be
        return be

    def _plan_for(self, backend: SweepBackend, batch: SweepBatch) -> SweepPlan:
        """The backend's structural plan for this batch, LRU-cached by
        union-subgraph content hash (the padded edge structure itself, so a
        changed graph can never be served a stale layout).

        With a ``spill_dir``, plans also persist next to the vector spill
        (``serve.spill.PlanSpill``): a cache miss tries the disk copy
        before rebuilding (``plan_restored``), and every built or patched
        plan is written through (``plan_spilled``)."""
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
        # weight-blind probe: an edge-weight delta changed skey but not the
        # topology, so a same-topology predecessor plan's layout can be
        # value-patched instead of rebuilt. The probe is hit/miss-neutral;
        # a successful patch counts service.delta.patched, a failed one
        # falls through to the rebuild (service.delta.replanned).
        tkey = (backend.name, backend.plan_params(),
                topology_key(batch.src, batch.dst, batch.h0.shape[0],
                             batch.dtype), stop)
        with self._lock:
            old_key = self._topo_index.get(tkey)
            old_plan = (self._plans.peek(old_key)
                        if old_key is not None and old_key != key else None)
        if old_plan is not None:
            plan = backend.patch(old_plan, batch, skey)
            if plan is not None:
                with self._lock:
                    self._plans.put(key, plan)
                    self._topo_index[tkey] = key
                    self.telemetry.counter("service.delta.patched",
                                           backend.name).inc()
                    self.stats["plan_evictions"] = \
                        self._plans.stats["evictions"]
                self._spill_plan(backend, key, plan)
                return plan
        if self._plan_spill is not None:  # disk before rebuild (restart)
            plan = self._restore_plan(backend, key, skey)
            if plan is not None:
                with self._lock:
                    self._plans.put(key, plan)
                    self._topo_index[tkey] = key
                    self.stats["plan_restored"] += 1
                    self.stats["plan_evictions"] = \
                        self._plans.stats["evictions"]
                return plan
        plan = backend.plan(batch, skey)
        with self._lock:
            self._plans.put(key, plan)
            self._topo_index[tkey] = key
            if len(self._topo_index) > 4 * max(self.cfg.plan_cache_size, 1):
                self._topo_index.clear()  # advisory index; rebuilt by use
            self.stats["plan_misses"] += 1
            if old_plan is not None:
                self._m_delta_replanned.inc()
            self.stats["plan_evictions"] = self._plans.stats["evictions"]
        self._spill_plan(backend, key, plan)
        return plan

    def _spill_plan(self, backend: SweepBackend, key: tuple,
                    plan: SweepPlan):
        """Write-through a built/patched plan to the plan spill.

        Durability is optional: a full disk or an unserializable meta must
        not fail a batch whose plan is already built and cached. On the
        card ``plan_arrays`` copies the plan back to the host, on the
        thread that built it."""
        if self._plan_spill is None:
            return
        try:
            arrays, meta = backend.plan_arrays(plan)
            with self._spill_io_lock:  # concurrent same-key builds
                self._plan_spill.put(key, arrays, meta)
            with self._lock:
                self.stats["plan_spilled"] += 1
        except (NotImplementedError, OSError, ValueError, TypeError):
            pass

    def _restore_plan(self, backend: SweepBackend, key: tuple,
                      skey: str) -> Optional[SweepPlan]:
        """A spilled plan for this cache key, rehydrated on the backend's
        device — or None (absent, foreign, corrupt, or mismatched layout
        params: a bad disk record means a rebuild, never a crash)."""
        rec = self._plan_spill.get(key)
        if rec is None:
            return None
        try:
            return backend.plan_restore(skey, *rec)
        except (NotImplementedError, KeyError, ValueError, TypeError):
            return None

    # -- cache ------------------------------------------------------------
    # Disk traffic (spill reads and writes) lives OUTSIDE the service lock:
    # the pipeline's assemble stage probes the spill after releasing it,
    # and writes queue in ``_spill_pending`` for ``_drain_spill`` —
    # otherwise every checkpoint write would serialize the prepare worker
    # against the publishing thread and erase the pipeline's overlap.

    def _cache_get_mem(self, key: str) -> Optional[_CacheEntry]:
        """In-memory LRU probe only (caller holds the lock); the spill
        fallback for misses is the assemble stage's, off the lock."""
        e = self._cache.get(key)
        if e is not None:
            self._cache.move_to_end(key)
        return e

    def _admit_spilled(self, key: str, d) -> Optional[_CacheEntry]:
        """Admit a record read back from the spill (caller holds the lock;
        the disk read already happened): validate, count the disk hit,
        restore LRU + warm-table state. No rewrite to disk."""
        live = self._cache_get_mem(key)
        if live is not None:
            # a concurrent run converged this key since the memory probe:
            # the live entry is fresher than the disk one
            return live
        e = self._entry_from_spill(d)
        if e is None:
            return None
        self.stats["spill_hits"] += 1
        self._admit(key, e)
        self._warm_h[e.nodes] = e.hub
        self._warm_seen[e.nodes] = True
        return e

    def _entry_from_spill(self, d) -> Optional[_CacheEntry]:
        """Validate a spilled record (a spill dir pointed at the wrong
        graph must not crash node indexing) -> entry or None."""
        if d is None:
            return None
        nodes = d["nodes"]
        if len(nodes) == 0 or len(d["authority"]) != len(nodes) \
                or len(d["hub"]) != len(nodes) \
                or int(nodes[-1]) >= self.g.n_nodes or int(nodes[0]) < 0:
            return None
        return _CacheEntry(nodes=nodes, authority=d["authority"],
                           hub=d["hub"])

    def _admit(self, key: str, e: _CacheEntry):
        """LRU insert + eviction (spilling evictees keeps them servable;
        the disk write is deferred to ``_drain_spill``)."""
        self._cache[key] = e
        self._cache.move_to_end(key)
        while len(self._cache) > self.cfg.cache_size:
            old_key, old = self._cache.popitem(last=False)
            # under "all" every converged entry was spilled at _cache_put
            if self._spill is not None and self.cfg.spill_policy == "evict":
                self._spill_pending.append((old_key, old.nodes,
                                            old.authority, old.hub))

    def _cache_put(self, key: str, e: _CacheEntry):
        if self._spill is not None and self.cfg.spill_policy == "all":
            self._spill_pending.append((key, e.nodes, e.authority, e.hub))
        self._admit(key, e)

    def _drain_spill(self):
        """Flush deferred spill writes to disk, OUTSIDE the service lock.

        Writes are serialized by the spill IO lock (a sync ``rank`` beside
        the queue dispatcher could otherwise race ``checkpoint.save`` on
        the same key's generation) and are best-effort: a disk failure
        must never fail a batch whose results are already in memory.
        """
        if self._spill is None:
            return
        with self._lock:
            pending, self._spill_pending = self._spill_pending, []
        if not pending:
            return  # don't queue behind another thread's writes for a no-op
        written = 0
        with self._spill_io_lock:
            for key, nodes, authority, hub in pending:
                t0 = time.perf_counter()
                try:
                    self._spill.put(key, nodes, authority, hub)
                    written += 1
                except (OSError, ValueError):
                    continue
                self._m_spill_write.observe(
                    (time.perf_counter() - t0) * 1e3)
        if written:
            with self._lock:
                self.stats["spill_writes"] += written

    def _restore_spilled(self):
        """Repopulate the LRU (newest-spilled most recent) and the global
        warm table from a previous process's spill directory."""
        restored = list(self._spill.load_recent(limit=self.cfg.cache_size))
        n = 0
        for key, d in reversed(restored):  # oldest first -> newest ends MRU
            e = self._entry_from_spill(d)
            if e is None:
                continue
            self._admit(key, e)
            self._warm_h[e.nodes] = e.hub
            self._warm_seen[e.nodes] = True
            n += 1
        self.stats["spill_restored"] = n

    def flush_spill(self):
        """Force-spill every in-memory entry (a graceful-shutdown drain for
        ``spill_policy="evict"``; under ``"all"`` everything is already on
        disk)."""
        if self._spill is None:
            raise ValueError("no spill_dir configured")
        self._drain_spill()  # deferred evictee writes aren't in the LRU
        with self._lock:
            entries = [(k, e.nodes, e.authority, e.hub)
                       for k, e in self._cache.items()]
        with self._spill_io_lock:
            for key, nodes, authority, hub in entries:
                t0 = time.perf_counter()
                self._spill.put(key, nodes, authority, hub)
                self._m_spill_write.observe(
                    (time.perf_counter() - t0) * 1e3)
        with self._lock:
            self.stats["spill_writes"] += len(entries)

    def gc_spill(self, keep: Optional[int] = None) -> int:
        """Compact the spill directory: prune each entry stream past its
        newest ``spill_keep_generations`` (or ``keep``) ``step_*``
        generations and sweep ``.tmp_*`` crash droppings, for vectors and
        plans both. Runs at init and on queue drain; counted under
        ``service.spill.gc_removed``. No-op (0) without a spill dir."""
        if self._spill is None:
            return 0
        with self._spill_io_lock:
            n = self._spill.gc(keep) + self._plan_spill.gc(keep)
        if n:
            with self._lock:
                self.stats["spill_gc_removed"] += n
        return n

    def clear_result_cache(self):
        """Drop all converged-vector state (LRU entries, pending spill
        writes, the warm-start table) while keeping cached plans.

        With a spill configured, clearing also bumps the spill's data
        generation: everything on disk was written under the old one and
        now reads as absent, so cleared state stays cleared across both
        the disk fallback and a restart's restore."""
        with self._lock:
            self._cache.clear()
            self._spill_pending.clear()  # pre-clear vectors; must not land
            self._warm_h[:] = 0.0
            self._warm_seen[:] = False
        if self._spill is not None:
            with self._spill_io_lock:
                self._spill.bump_data_generation()

    def apply_edge_delta(self, adds=None, removes=None,
                         reweights=None) -> dict:
        """Roll an edge changeset into the running service (see
        ``serve.delta``).

        ``adds``: (src, dst) or (src, dst, w) rows; ``removes``: (src,
        dst) rows; ``reweights``: (src, dst, w) rows. Weights must be
        finite and nonzero (reweight-to-0 is a remove). Node ids are
        fixed at construction — deltas change edges only.

        What survives: the warm table, entirely (post-delta refreshes
        warm-start from the pre-delta fixed points); plans — a weight-only
        delta keeps every topology, so the next lookup value-patches the
        cached layout (``service.delta.patched``), and a structural delta
        rebuilds only plans whose union subgraphs changed; cached results
        whose node set misses every changed edge's endpoints (the rest are
        invalidated: ``service.delta.invalidated``).

        What cannot survive: pre-delta vectors of touched subgraphs — in
        memory (invalidated here), in flight to disk (pending writes
        dropped), and on disk (the spill's data generation bumps, so the
        disk fallback and a restart read them as absent; the surviving
        entries re-spill under the new generation when ``spill_policy``
        is "all").

        Call it between batches (no batch in flight against the pre-delta
        graph), e.g. inside a queue drain window (drain -> apply_edge_delta
        -> undrain, ``launch.serve_rank.roll_delta``). Returns a summary
        dict (``data_generation``: the spill's new generation, None without
        a spill); timing goes to ``service.delta.swap_ms``.
        """
        t0 = time.perf_counter()
        delta = EdgeDelta.normalize(adds, removes, reweights,
                                    self.g.n_nodes)
        if delta.empty:
            return {"structural": False, "invalidated": 0,
                    "touched_nodes": 0, "data_generation": None,
                    "swap_ms": 0.0}
        new_g, table = apply_to_graph(self.g, self._edge_table, delta)
        touched = delta.touched_nodes()
        with self._lock:
            if delta.structural:
                self.g = new_g
                self.extractor = SubgraphExtractor(new_g, self.cfg.out_cap,
                                                   self.cfg.in_cap)
            self._edge_table = table
            doomed = {k for k, e in self._cache.items()
                      if np.isin(e.nodes, touched, assume_unique=True).any()}
            for k in doomed:
                del self._cache[k]
            self._m_delta_invalidated.inc(len(doomed))
            # in-flight writes of now-stale vectors must not reach disk
            self._spill_pending = [p for p in self._spill_pending
                                   if p[0] not in doomed]
            survivors = [(k, e.nodes, e.authority, e.hub)
                         for k, e in self._cache.items()]
        gen = None
        if self._spill is not None:
            with self._spill_io_lock:
                gen = self._spill.bump_data_generation()
            if self.cfg.spill_policy == "all" and survivors:
                # everything on disk just went stale; re-spill the still-
                # valid entries under the new generation so a restart keeps
                # them (only pre-delta state of touched subgraphs must die)
                with self._lock:
                    self._spill_pending.extend(survivors)
                self._drain_spill()
        swap_ms = (time.perf_counter() - t0) * 1e3
        self._m_delta_swap.observe(swap_ms)
        return {"structural": delta.structural, "invalidated": len(doomed),
                "touched_nodes": int(len(touched)), "data_generation": gen,
                "swap_ms": swap_ms}

    def _union_weights(self, nodes: np.ndarray, src_loc: np.ndarray,
                       dst_loc: np.ndarray) -> Optional[np.ndarray]:
        """Per-edge weights for a union subgraph's induced edges (local
        endpoint arrays + the local->global node map), or None when no
        delta was ever applied (all 1.0: assemble keeps its constant fill
        and the reference's structure keys)."""
        table = self._edge_table
        if table is None:
            return None
        return lookup_weights(table, self.g.n_nodes, nodes[src_loc],
                              nodes[dst_loc])

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
