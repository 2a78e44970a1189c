"""Stage-decomposed serving pipeline with host/device overlap (port of
``repro.serve.pipeline``).

``ServePipeline`` is the only execution path of ``RankService``. Each
batch's lifecycle decomposes into four stages:

* ``assemble`` — root-set cache probe, in-batch dedup, union-subgraph
  extraction, padding, per-column induced weights and start vectors.
  Pure host work.
* ``plan``     — ``PlanCache`` lookup (build on miss) of
  the backend's structural layout. Host + transfer work.
* ``sweep``    — the device convergence loop via the ``SweepBackend``.
* ``publish``  — cache insert, warm-table update, result construction,
  stats, and frontend completion (``job.on_done``).

``run(jobs)`` executes a job stream through those stages. With
``depth == 1`` everything runs inline on the caller's thread — the exact
serial semantics the old code had. With ``depth >= 2`` a front worker
thread runs ``assemble``+``plan`` of upcoming jobs while the driving
thread runs ``sweep``+``publish`` of the current one (double-buffered for
depth 2; deeper pipelines prepare further ahead).

**Deterministic dataflow.** Overlap makes batch k+1's assembly read cache
/warm-start state that batch k has not yet published. Left unsynchronized
that read would *race* publish(k) and make statuses/iteration counts
flicker run to run. The pipeline instead pins the dataflow: at depth d,
``assemble(j)`` reads service state exactly as of ``publish(j-d)`` —
enforced by two barriers (the front gate delays prepare(j) until
publish(j-d) completes; the driving thread delays publish(k) until every
prepare entitled to pre-publish(k) state finishes — an exact count for sized job
sources like the sync ``rank`` path, in-flight-only for the queue's live
stream, which can block indefinitely awaiting arrivals and is inherently
timing-dependent anyway). Pipelined sync runs are therefore reproducible,
and two identically-configured services serve identical statuses,
iteration counts, and bit-identical scores. Scores stay within O(tol) of
the serial schedule on either frontend (all schedules converge to the
same fixed points), which the bench gates at <=1e-10.

``RankService.rank`` submits v_max-sized jobs from a list. On the card a
plan built by the prepare thread carries a CUDA event
(``SweepPlan.ready``) that the sweep waits on before reading it.
"""
from __future__ import annotations

import dataclasses
import itertools
import queue as _queue
import threading
import time
from collections import deque
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

from ..core.weights import accel_weights
from ..graph.structure import next_pow2
from ..graph.subgraph import root_set_key
from .backends import SweepBatch


@dataclasses.dataclass
class PipelineJob:
    """One dispatchable unit: up to ``v_max`` validated root sets.

    ``queries`` must already be ``RankService.validate_roots`` output (the
    frontends validate in the caller's thread so a bad request can never
    poison a batch). ``tag`` is opaque frontend payload (the queue stores
    its ``_Pending`` list there); ``on_done(job, results, exc)`` runs at
    the end of ``publish`` — or with the exception if any stage failed —
    on the pipeline's driving thread. ``rank_k`` overrides the service's
    configured rank-stability k for this job only (the queue degrades it
    under backlog); None means "use the config".
    """

    queries: List[np.ndarray]
    refresh: bool = False
    tag: Any = None
    on_done: Optional[Callable] = None
    rank_k: Optional[int] = None


@dataclasses.dataclass
class _Assembled:
    """A job mid-flight: per-stage products accumulate on this record."""

    job: PipelineJob
    results: list                  # slot -> QueryResult (hits prefilled)
    todo: list                     # (slot, FocusedSubgraph, warm_entry|None)
    dups: list                     # (slot, owner_slot)
    statuses: list                 # per-todo "warm" | "cold"
    locs: list                     # per-todo union-local index arrays
    backend: Any = None
    batch: Optional[SweepBatch] = None
    lump: Any = None               # LumpMap when the batch is lump-reduced
    plan: Any = None
    h: Any = None
    a: Any = None
    conv: Any = None
    res: Any = None                # per-column residual certificates


_DONE = object()
_STAGES = ("assemble", "plan", "sweep", "publish")


class _Run:
    """Per-``run`` synchronization state for the depth>=2 executor."""

    def __init__(self, depth: int):
        self.depth = depth
        self.cond = threading.Condition()
        self.prepared = 0        # prepares (assemble+plan) completed
        self.published = 0       # jobs fully published (or failed)
        self.inflight = False    # a prepare is running right now
        self.front_done = False
        self.stop = threading.Event()
        self.out: "_queue.Queue" = _queue.Queue()


class ServePipeline:
    """The staged batch executor one ``RankService`` serves through."""

    def __init__(self, service, depth: int = 2):
        depth = int(depth)
        if depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {depth}")
        self.svc = service
        self.depth = depth
        # one sweep on device at a time, across every frontend and every
        # concurrent run (sync rank() callers + the queue dispatcher)
        self._sweep_lock = threading.Lock()
        self._meta_lock = threading.Lock()
        self._run_ids = itertools.count()
        self.trace = deque(maxlen=1024)  # (run, job, stage, t0, t1)
        self._spans = {}  # (run, job) -> {stage: (t0, t1)}, size-bounded
        # counts live in the service's registry (pipeline.* family); the
        # legacy dict surface stays as an alias view (see serve.telemetry)
        from .telemetry import LegacyStatsDict
        reg = service.telemetry
        self.stats = LegacyStatsDict({
            k: reg.counter(f"pipeline.{k}")
            for k in ("runs", "jobs", "swept", "job_errors", "overlapped")})
        # per-stage wall-time histograms, fed by _traced
        self._m_stage = {s: reg.histogram("pipeline.stage_ms", s)
                         for s in _STAGES}

    # -- stages -----------------------------------------------------------

    def assemble(self, job: PipelineJob) -> _Assembled:
        """Host half #1: cache probe + dedup + union extraction + padding.

        State reads (vector cache, warm table) happen under the service
        lock; the expensive extraction runs outside it.
        """
        from .rank_service import QueryResult

        svc = self.svc
        queries = job.queries
        asm = _Assembled(job=job, results=[None] * len(queries), todo=[],
                         dups=[], statuses=[], locs=[])
        # cache hits are served without touching the device; identical
        # uncached root sets in one job share a single column. Counters
        # (batches/queries/hit/warm/cold) are deliberately NOT bumped
        # here but in publish: a prefetched job abandoned by an earlier
        # job's failure must not leave phantom served-work stats.
        probes = []      # [slot, roots, key, entry|None]
        with svc._lock:
            for slot, roots_u in enumerate(queries):
                key = root_set_key(roots_u)
                probes.append([slot, roots_u, key,
                               svc._cache_get_mem(key)])
        dup_of = {}      # key -> slot of the column that computes it
        misses = []      # (slot, roots, warm_entry|None)
        with svc._lock:
            for slot, roots_u, key, entry in probes:
                if entry is not None and not job.refresh:
                    asm.results[slot] = QueryResult(
                        roots=roots_u, nodes=entry.nodes,
                        authority=entry.authority, hub=entry.hub,
                        iters=0, status="hit", key=key,
                        residual=entry.residual)
                    continue
                if key in dup_of:
                    asm.dups.append((slot, dup_of[key]))
                    continue
                dup_of[key] = slot
                misses.append((slot, roots_u, entry))
        if not misses:
            return asm  # all hits: nothing to plan/sweep

        # the expensive host half — subgraph extraction — off the lock
        for slot, roots_u, entry in misses:
            asm.todo.append((slot, svc.extractor.extract(roots_u), entry))
        subs = [t[1] for t in asm.todo]
        union = svc.extractor.extract_union(subs)
        nodes_u = union.nodes
        n_u, e_u = len(nodes_u), union.graph.n_edges
        n_pad = next_pow2(max(n_u + 1, 16))  # +1: a guaranteed-dead pad row
        e_pad = next_pow2(max(e_u, 16))
        V = svc.cfg.v_max

        src = np.full(e_pad, n_pad - 1, np.int32)
        dst = np.full(e_pad, n_pad - 1, np.int32)
        w = np.zeros(e_pad)
        src[:e_u] = union.graph.src
        dst[:e_u] = union.graph.dst
        w[:e_u] = 1.0

        ca = np.zeros((n_pad, V))
        ch = np.zeros((n_pad, V))
        mask = np.zeros((n_pad, V))
        h0 = np.zeros((n_pad, V))
        asm.statuses = [""] * len(asm.todo)
        cols = []
        for j, (_slot, fs, _entry) in enumerate(asm.todo):
            loc = np.searchsorted(nodes_u, fs.nodes)      # S_j in union ids
            asm.locs.append(loc)
            m = np.zeros(n_u, bool)
            m[loc] = True
            # induced degrees of S_j (edges with both endpoints in S_j)
            sel = m[union.graph.src] & m[union.graph.dst]
            indeg = np.bincount(union.graph.dst[sel], minlength=n_u)
            outdeg = np.bincount(union.graph.src[sel], minlength=n_u)
            ca_j, ch_j = accel_weights(indeg, outdeg)
            ca[:n_u, j] = ca_j * m
            ch[:n_u, j] = ch_j * m
            mask[:n_u, j] = m
            cols.append((j, fs, m, loc))
        # warm-table reads back under the lock
        with svc._lock:
            for j, fs, m, loc in cols:
                entry = asm.todo[j][2]
                h0[:n_u, j], asm.statuses[j] = \
                    svc._start_vector(fs, entry, m, loc)
            asm.backend = svc._backend_for(n_u, e_u)
        rank_k = svc.cfg.rank_k if job.rank_k is None else int(job.rank_k)
        asm.batch = SweepBatch(
            h0=h0, src=src, dst=dst, w=w, ca=ca, ch=ch, mask=mask,
            tol=svc._polish_tol, max_iter=svc.cfg.max_iter,
            dtype=svc._dtype, rank_k=rank_k,
            stable_sweeps=svc.cfg.stable_sweeps,
            bulk_dtype=svc._bulk_dtype)
        if svc._lumping is not None:
            # plan-time lumped reduction (serve.plans): every backend
            # plans and sweeps the reduced arrays; the sweep stage unlumps
            # back to the full node space before publish reads anything
            from .plans import LUMP_AUTO_MIN_RATIO, lump_batch
            min_ratio = (LUMP_AUTO_MIN_RATIO
                         if svc._lumping == "auto" else 0.0)
            red, lmap = lump_batch(asm.batch, min_ratio=min_ratio)
            if red is not None:
                asm.batch, asm.lump = red, lmap
        return asm

    def plan(self, asm: _Assembled) -> _Assembled:
        """Host half #2: the backend's structural layout, via the plan
        cache (built on miss)."""
        if asm.batch is not None:
            asm.plan = self.svc._plan_for(asm.backend, asm.batch)
        return asm

    def sweep(self, asm: _Assembled) -> _Assembled:
        """Device half: the backend convergence loop (serialized — one
        sweep on device at a time, whatever thread drives it)."""
        if asm.batch is None:
            return asm
        with self._sweep_lock:
            asm.h, asm.a, asm.conv, asm.res = \
                asm.backend.sweep(asm.plan, asm.batch)
        if asm.lump is not None:
            # exact unlump: scatter representative scores to class members
            # and renormalize, so publish (and through it the cache, warm
            # table) only ever sees full-space vectors
            from .plans import unlump_cols
            asm.h, asm.a = unlump_cols(asm.h, asm.a, asm.lump)
        with self._meta_lock:
            self.stats["swept"] += 1
        return asm

    def publish(self, asm: _Assembled) -> list:
        """State mutation half: cache/warm-table writes, result
        construction, stats — under the service lock."""
        from .rank_service import QueryResult, _CacheEntry

        svc = self.svc
        with svc._lock:
            # served-work accounting lives here, not in assemble: a job
            # assembled ahead but never published (an earlier job failed
            # the run) must not count
            svc.stats["batches"] += 1
            svc.stats["queries"] += len(asm.job.queries)
            svc.stats["hit"] += sum(1 for r in asm.results
                                    if r is not None and r.status == "hit")
            for s in asm.statuses:
                svc.stats[s] += 1
        if asm.batch is None:
            return asm.results  # all hits: nothing was swept or mutated
        from ..kernels.ops import classify_exit
        reasons = classify_exit(
            np.asarray(asm.conv)[: len(asm.todo)],
            np.asarray(asm.res)[: len(asm.todo)],
            tol=asm.batch.tol, max_iter=asm.batch.max_iter,
            rank_k=asm.batch.rank_k, stable_sweeps=asm.batch.stable_sweeps)
        with svc._lock:
            svc.stats["sweeps"] += int(asm.conv.max(initial=0))
            bb = svc.stats["backend_batches"]
            bb[asm.backend.name] = bb.get(asm.backend.name, 0) + 1
            # per-column convergence telemetry: sweep-count distribution
            # and exit reasons (residual | rank_stable | max_iter) — the
            # live view of the paper's acceleration claim and the
            # slow-rank pathology (see docs/OPERATIONS.md)
            for j in range(len(asm.todo)):
                svc._m_sweep_iters.observe(int(asm.conv[j]))
                svc.telemetry.counter("service.exit", reasons[j]).inc()
            if asm.batch.bulk_dtype is not None:
                svc._m_ladder.inc()
            if asm.lump is not None:
                # lumping telemetry counts with the served work (an
                # assembled-but-abandoned job must not leave phantom stats)
                svc._m_lumped_nodes.inc(asm.lump.lumped_nodes)
                svc._m_reduction_ratio.observe(asm.lump.ratio)
            for j, (slot, fs, _entry) in enumerate(asm.todo):
                loc = asm.locs[j]
                auth_j, hub_j = asm.a[loc, j], asm.h[loc, j]
                res_j = float(asm.res[j])
                entry = _CacheEntry(nodes=fs.nodes, authority=auth_j,
                                    hub=hub_j, residual=res_j)
                svc._cache_put(fs.key, entry)
                svc._warm_h[fs.nodes] = hub_j
                svc._warm_seen[fs.nodes] = True
                asm.results[slot] = QueryResult(
                    roots=fs.nodes[fs.roots_local], nodes=fs.nodes,
                    authority=auth_j, hub=hub_j, iters=int(asm.conv[j]),
                    status=asm.statuses[j], key=fs.key, residual=res_j)
            for slot, owner in asm.dups:  # identical root sets share a col
                asm.results[slot] = asm.results[owner]
                svc.stats[asm.results[owner].status] += 1
        return asm.results

    # -- tracing ----------------------------------------------------------

    @staticmethod
    def _intersects(a, b) -> bool:
        return a is not None and b is not None and a[0] < b[1] and a[1] > b[0]

    def _traced(self, fn, arg, run_id: int, j: int, stage: str):
        t0 = time.perf_counter()
        try:
            return fn(arg)
        finally:
            t1 = time.perf_counter()
            self._m_stage[stage].observe((t1 - t0) * 1e3)
            with self._meta_lock:
                self.trace.append((run_id, j, stage, t0, t1))
                # incremental overlap accounting: an overlap pair —
                # assemble(j) against sweep(j-1) — is counted when its
                # SECOND record lands, so the running total stays exact
                # past the trace deque's window
                sp = self._spans.setdefault((run_id, j), {})
                sp[stage] = (t0, t1)
                if stage == "assemble":
                    prev = self._spans.get((run_id, j - 1), {})
                    if self._intersects(prev.get("sweep"), (t0, t1)):
                        self.stats["overlapped"] += 1
                elif stage == "sweep":
                    nxt = self._spans.get((run_id, j + 1), {})
                    if self._intersects(nxt.get("assemble"), (t0, t1)):
                        self.stats["overlapped"] += 1
                while len(self._spans) > 64:
                    self._spans.pop(next(iter(self._spans)))

    def _prepare(self, job: PipelineJob, run_id: int, j: int) -> _Assembled:
        asm = self._traced(self.assemble, job, run_id, j, "assemble")
        return self._traced(self.plan, asm, run_id, j, "plan")

    def overlap_events(self, run_id: Optional[int] = None) -> int:
        """How many jobs' ``assemble`` interval intersected the previous
        job's ``sweep`` interval — the overlap-evidence probe the tests
        and the bench assert on (0 under depth-1 by construction).

        With no ``run_id`` this is the exact lifetime total (counted
        incrementally, immune to trace eviction); per-run queries scan
        the trace and see only its bounded window.
        """
        with self._meta_lock:
            if run_id is None:
                return self.stats["overlapped"]
            entries = list(self.trace)
        spans = {}  # (run, job) -> {stage: (t0, t1)}
        for run, j, stage, t0, t1 in entries:
            if run == run_id:
                spans.setdefault((run, j), {})[stage] = (t0, t1)
        n = 0
        for (run, j), s in spans.items():
            prev = spans.get((run, j - 1), {})
            if self._intersects(prev.get("sweep"), s.get("assemble")):
                n += 1
        return n

    # -- executors --------------------------------------------------------

    def run(self, jobs: Iterable[PipelineJob], depth: Optional[int] = None):
        """Execute a job stream; yields ``(job, results, exc)`` per job in
        submission order. ``results`` is slot-aligned with ``job.queries``
        (None when ``exc`` is set). Job errors are delivered, not raised —
        the stream keeps going; only a broken job *iterator* raises.
        """
        depth = self.depth if depth is None else max(1, int(depth))
        run_id = next(self._run_ids)
        with self._meta_lock:
            self.stats["runs"] += 1
        total = len(jobs) if hasattr(jobs, "__len__") else None
        # a single job can't overlap anything — skip the worker machinery
        if depth == 1 or (total is not None and total <= 1):
            yield from self._run_serial(jobs, run_id)
            return
        yield from self._run_pipelined(jobs, run_id, depth, total)

    def _finish(self, job, results, exc):
        with self._meta_lock:
            self.stats["jobs"] += 1
            if exc is not None:
                self.stats["job_errors"] += 1
        if job.on_done is not None:
            job.on_done(job, results, exc)
        return job, results, exc

    def _run_serial(self, jobs, run_id: int):
        """depth-1: the degenerate serial case — assemble(j) reads the
        state publish(j-1) left, exactly the pre-pipeline semantics."""
        for j, job in enumerate(jobs):
            results, exc = None, None
            try:
                asm = self._prepare(job, run_id, j)
                self._traced(self.sweep, asm, run_id, j, "sweep")
                results = self._traced(self.publish, asm, run_id, j,
                                       "publish")
            except BaseException as e:  # noqa: BLE001 — delivered per job
                exc = e
            yield self._finish(job, results, exc)

    def _front(self, it, st: _Run, run_id: int):
        """Worker loop: pull jobs, gate, prepare, hand off to the driving
        thread.

        Runs ``next(it)`` here too, so a blocking job source (the queue's
        deadline wait) also overlaps the driving thread's device sweep.
        """
        j = 0
        try:
            while not st.stop.is_set():
                try:
                    job = next(it)
                except StopIteration:
                    return
                with st.cond:
                    # front gate: assemble(j) may not start before
                    # publish(j - depth) has completed
                    while (st.published < j - st.depth + 1
                           and not st.stop.is_set()):
                        st.cond.wait(0.2)
                    if st.stop.is_set():
                        return
                    st.inflight = True
                try:
                    item = (j, job, self._prepare(job, run_id, j), None)
                except BaseException as e:  # noqa: BLE001 — to the driving side
                    item = (j, job, None, e)
                finally:
                    with st.cond:
                        st.inflight = False
                        st.prepared += 1
                        st.cond.notify_all()
                st.out.put(item)
                j += 1
        except BaseException as e:  # noqa: BLE001 — the job source raised
            st.out.put((j, None, None, e))
        finally:
            with st.cond:
                st.front_done = True
                st.cond.notify_all()
            st.out.put(_DONE)

    def _publish_barrier(self, st: _Run, j: int, depth: int,
                         total: Optional[int]):
        """Wait out every prepare entitled to read pre-publish(j) state
        (the front gate bounds those to indices < j + depth).

        For a sized job source (sync ``rank``) the bound is exact —
        prepared must reach min(j + depth, total) — which closes the
        window where the front is *between* prepares and makes the
        schedule fully deterministic. An unsized source (the queue's live
        stream) can block indefinitely in ``next``, so there the barrier
        only waits on a prepare already in flight: publishes never stall
        on future arrivals, at the cost of arrival-timing-dependent (but
        still torn-read-free) warm-start state.
        """
        with st.cond:
            if total is not None:
                while (st.prepared < min(j + depth, total)
                       and not st.stop.is_set()):
                    st.cond.wait(0.2)
            else:
                while (st.inflight and st.prepared <= j + depth - 1
                       and not st.stop.is_set()):
                    st.cond.wait(0.2)

    def _run_pipelined(self, jobs, run_id: int, depth: int,
                       total: Optional[int]):
        st = _Run(depth)
        worker = threading.Thread(
            target=self._front, args=(iter(jobs), st, run_id),
            daemon=True, name="rank-pipeline-front")
        worker.start()
        try:
            while True:
                item = st.out.get()
                if item is _DONE:
                    break
                j, job, asm, exc = item
                if job is None:
                    raise exc  # the job iterator itself broke
                results = None
                if exc is None:
                    try:
                        self._traced(self.sweep, asm, run_id, j, "sweep")
                        self._publish_barrier(st, j, depth, total)
                        results = self._traced(self.publish, asm, run_id,
                                               j, "publish")
                    except BaseException as e:  # noqa: BLE001 — per job
                        exc = e
                with st.cond:
                    st.published += 1  # advance even on failure: the front
                    st.cond.notify_all()  # gate must never deadlock
                yield self._finish(job, results, exc)
        finally:
            st.stop.set()
            with st.cond:
                st.cond.notify_all()
            worker.join(timeout=60)
