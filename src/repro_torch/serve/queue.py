"""Async micro-batching frontend for the query-ranking service (port of
``repro.serve.queue``; the same code over the port's pipeline).

``RankService.rank`` is synchronous: a caller hands it a ready-made list
and the traversal runs at whatever width that list happens to have. Under
live traffic queries arrive one at a time, so without a queue every
request would run as a V=1 sweep and the batched-column win (one edge
traversal serving ``v_max`` users) evaporates. ``RankQueue`` closes that
gap: callers ``submit`` individual root sets and get a ticket back;
submissions accumulate until either ``v_max`` distinct root sets are
pending or the oldest has waited ``deadline_ms`` — whichever comes first —
then one batched sweep dispatches through the service's configured
``SweepBackend`` and every waiting ticket resolves.

Duplicate root sets in flight coalesce into one pending column (the ticket
fan-out mirrors ``RankService``'s in-batch dedup, but at queue level the
duplicates never consume queue depth or batch columns), and a bounded
pending set gives natural backpressure: ``submit`` blocks once
``max_pending`` distinct root sets are waiting.

**SLA-aware admission.** Each submit carries a priority class (lower =
more important; default 0 = guaranteed) and an optional per-request
deadline. Batch formation is EDF — ``_take_batch`` serves the earliest
deadlines first (deadline-less submits keep FIFO order among themselves)
— and under overload the queue sheds instead of collapsing: when the
pending set is full, a best-effort submit (priority >= ``shed_priority``)
resolves immediately with a ``status="shed"`` result, and a guaranteed
submit evicts the least-urgent sheddable pending column rather than
blocking behind it. When the backlog still exceeds a batch width at
dispatch time, the job's effective ``rank_k`` halves (coarser
rank-stability certificates, fewer sweeps per query) — degrade the
quality dial, not everyone's p99. Per-class latency, ``shed``,
``deadline_miss`` and ``degraded`` counters surface through
``snapshot_stats()``.

On the card the pipeline's prepare worker (which pulls this queue's job
stream) does assemble, plan and the plan's host-to-device copies, and the
dispatcher thread (the pipeline's driving thread) builds, launches and
reads each batch's K2 graph; both bind the service's device first
(``runtime.bind_thread``).

Dispatch itself is the service's staged ``ServePipeline`` — the same
assemble → plan → sweep → publish path the synchronous ``rank()`` takes.
The queue contributes only a *job stream*: each flush decision (v_max
width or deadline, whichever first) yields one ``PipelineJob`` whose
``on_done`` resolves the batch's tickets at publish time. Because the
pipeline pulls that stream from its prepare worker, at
``pipeline_depth >= 2`` both the deadline wait and the next batch's host
assembly overlap the previous batch's device sweep; the pipeline's sweep
lock keeps backends from ever seeing concurrent sweeps (including
``flush``/``close`` drains on the caller's thread).

**Shutdown.** ``close()`` stops admission and serves everything pending —
the orderly exit. ``drain()`` is the *operator* exit (what the launcher
runs on SIGTERM/SIGINT): stop admission, resolve every still-pending
best-effort column with ``status="shed"`` immediately, serve the
guaranteed pending, then flush (and generation-GC) the service's spill so
a successor process restarts warm. Admission, shedding, per-class EDF
wait and latency all count into the queue's own typed
``serve.telemetry.MetricsRegistry`` (``self.telemetry``; the legacy
``stats`` dict is an alias view) — see ``docs/OPERATIONS.md`` for the
metric reference and drain contract, ``docs/ARCHITECTURE.md`` for where
the queue sits in the serving stack.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import OrderedDict
from typing import List, Optional, Sequence

import numpy as np

from ..graph.subgraph import root_set_key
from ..runtime import bind_thread
from .pipeline import PipelineJob

# per-class latency samples kept for percentile reporting (bounded so a
# long-lived queue never grows without bound)
_LAT_WINDOW = 4096


class QueueTicket:
    """A pending query's handle: blocks on ``result()`` until its batch
    dispatches (or the queue rejects/sheds it)."""

    def __init__(self, key: str, priority: int = 0,
                 deadline_at: float = math.inf):
        self.key = key
        self.priority = int(priority)
        self.deadline_at = float(deadline_at)  # perf_counter instant
        self.submitted_at = time.perf_counter()
        self._done = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None
        self.latency_s: Optional[float] = None  # submit -> resolve
        self.resolved_at: Optional[float] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None):
        """The query's ``QueryResult`` (raises what the dispatch raised)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.key[:12]} still pending")
        if self._exc is not None:
            raise self._exc
        return self._result

    def _resolve(self, result, exc: Optional[BaseException] = None):
        self._result, self._exc = result, exc
        self.resolved_at = time.perf_counter()
        self.latency_s = self.resolved_at - self.submitted_at
        self._done.set()


@dataclasses.dataclass
class _Pending:
    roots: np.ndarray
    tickets: List[QueueTicket]
    submitted_at: float
    priority: int = 0
    deadline_at: float = math.inf


class RankQueue:
    """Deadline/width micro-batching queue in front of one ``RankService``.

    ``deadline_ms`` bounds the extra latency batching may add to any
    request; ``max_pending`` bounds how many distinct root sets may wait
    (further ``submit`` calls block — backpressure, not unbounded memory).
    """

    def __init__(self, service, deadline_ms: float = 5.0,
                 max_pending: Optional[int] = None, shed_priority: int = 1,
                 dispatch_margin_ms: float = 25.0):
        self.service = service
        self.v_max = service.cfg.v_max
        self.deadline_s = float(deadline_ms) / 1e3
        # how far ahead of a request's own deadline_at the flush timer
        # fires, budgeting for dispatch+sweep time — without it a tight
        # per-request deadline into a quiet queue would sit out the full
        # queue deadline_ms and miss its SLA before EDF even sees it
        self.margin_s = float(dispatch_margin_ms) / 1e3
        self.max_pending = (4 * self.v_max if max_pending is None
                            else int(max_pending))
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        # classes >= shed_priority are best-effort (sheddable under
        # overload); classes below are guaranteed (backpressure-blocking)
        self.shed_priority = int(shed_priority)
        self._cond = threading.Condition()
        self._pending: "OrderedDict[str, _Pending]" = OrderedDict()
        self._closed = False
        # each queue owns its registry (two queues over one service must
        # not merge admission counts); the legacy dict is an alias view
        from .telemetry import LegacyStatsDict, MetricsRegistry
        reg = self.telemetry = MetricsRegistry()
        self.stats = LegacyStatsDict({
            "submitted": reg.counter("queue.submitted"),
            "coalesced": reg.counter("queue.coalesced"),
            "batches": reg.counter("queue.batches"),
            "flush_vmax": reg.counter("queue.flush.vmax"),
            "flush_deadline": reg.counter("queue.flush.deadline"),
            "flush_drain": reg.counter("queue.flush.drain"),
            "flush_close": reg.counter("queue.flush.close"),
            "max_batch": reg.gauge("queue.max_batch"),
            "shed": reg.counter("queue.shed"),
            "shed_evicted": reg.counter("queue.shed_evicted"),
            "deadline_miss": reg.counter("queue.deadline_miss"),
            "degraded": reg.counter("queue.degraded"),
        })
        self._m_wait = reg.histogram("queue.wait_ms")  # submit -> dispatch
        reg.gauge("queue.pending")
        reg.counter("queue.drains")
        reg.counter("queue.undrains")
        # pre-register the per-class families (label = priority class) so
        # the metric name set is complete before the first submit
        for k in ("submitted", "served", "shed", "failed"):
            reg.counter(f"queue.class.{k}", "0")
        reg.histogram("queue.class.latency_ms", "0", window=_LAT_WINDOW)
        self._class_stats: dict = {}  # priority -> metric handles
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rank-queue-dispatch")
        self._thread.start()

    # -- client side ------------------------------------------------------

    def submit(self, roots: Sequence[int], priority: int = 0,
               deadline_ms: Optional[float] = None) -> QueueTicket:
        """Enqueue one root set; returns immediately with a ticket.

        Invalid root sets raise here, in the caller's thread, so one bad
        request can never poison a batch of good ones at dispatch time.

        ``priority`` is the request's class (lower = more important;
        classes >= the queue's ``shed_priority`` are best-effort).
        ``deadline_ms`` is this request's SLA from now: batches form EDF
        over pending deadlines, and a resolve past the instant counts a
        ``deadline_miss``. Under a full pending set a best-effort submit
        resolves immediately with ``status="shed"`` (never blocks), and a
        guaranteed submit evicts the least-urgent sheddable column before
        falling back to blocking backpressure.
        """
        roots_u = self.service.validate_roots(roots)
        key = root_set_key(roots_u)
        priority = int(priority)
        deadline_at = (math.inf if deadline_ms is None
                       else time.perf_counter() + float(deadline_ms) / 1e3)
        with self._cond:
            if self._closed:
                raise RuntimeError("queue is closed")
            self.stats["submitted"] += 1
            self._class(priority)["submitted"] += 1
            t = self._coalesce(key, priority, deadline_at)
            if t is not None:  # one column serves all tickets for the key
                return t
            while len(self._pending) >= self.max_pending and not self._closed:
                if priority >= self.shed_priority:
                    # best-effort under overload: resolve as shed NOW
                    # rather than queue-blocking guaranteed traffic
                    t = QueueTicket(key, priority, deadline_at)
                    self._shed([t], roots_u)
                    return t
                if self._evict_sheddable():
                    continue  # room made for guaranteed work
                self._cond.wait(0.05)
                # the wait releases the lock: another thread may have queued
                # this same key meanwhile — inserting a second _Pending
                # would orphan that thread's tickets, so re-check
                t = self._coalesce(key, priority, deadline_at)
                if t is not None:
                    return t
            if self._closed:
                raise RuntimeError("queue is closed")
            t = QueueTicket(key, priority, deadline_at)
            self._pending[key] = _Pending(roots_u, [t], time.perf_counter(),
                                          priority, deadline_at)
            self._cond.notify_all()
            return t

    def _coalesce(self, key: str, priority: int = 0,
                  deadline_at: float = math.inf) -> Optional[QueueTicket]:
        """Under the lock: attach a ticket to ``key``'s pending column if
        one exists. The column inherits the most urgent class/deadline
        among its tickets (it serves all of them)."""
        p = self._pending.get(key)
        if p is None:
            return None
        t = QueueTicket(key, priority, deadline_at)
        p.tickets.append(t)
        p.priority = min(p.priority, priority)
        if deadline_at < p.deadline_at:
            # a tighter deadline joined the column: the dispatcher's flush
            # timer was derived from the OLD earliest deadline — wake it
            # so it re-derives the wait
            p.deadline_at = deadline_at
            self._cond.notify_all()
        self.stats["coalesced"] += 1
        return t

    # -- SLA admission (all under the lock) -------------------------------

    def _class(self, priority: int) -> dict:
        c = self._class_stats.get(priority)
        if c is None:
            lbl = str(priority)
            c = {k: self.telemetry.counter(f"queue.class.{k}", lbl)
                 for k in ("submitted", "served", "shed", "failed")}
            c["lat"] = self.telemetry.histogram("queue.class.latency_ms",
                                                lbl, window=_LAT_WINDOW)
            self._class_stats[priority] = c
        return c

    def _lat(self, c: dict, t: QueueTicket):
        c["lat"].observe(t.latency_s * 1e3)

    def _shed_result(self, roots_u: np.ndarray, key: str):
        """A ``QueryResult`` carrying the shed verdict: the request's own
        roots as the node set, zero scores, ``status="shed"`` — shaped
        like a served result so fan-out code needs no special case."""
        from .rank_service import QueryResult
        n = len(roots_u)
        return QueryResult(roots=roots_u, nodes=roots_u.copy(),
                           authority=np.zeros(n), hub=np.zeros(n),
                           iters=0, status="shed", key=key)

    def _shed(self, tickets: List[QueueTicket], roots_u: np.ndarray):
        # shed tickets resolve in microseconds; their ~0ms latencies must
        # NOT enter the per-class lat_ms window or an overloaded class
        # would report a BETTER p95 the more of its traffic gets dropped —
        # the percentile windows are served-only
        self.stats["shed"] += len(tickets)
        res = self._shed_result(roots_u, tickets[0].key)
        for t in tickets:
            t._resolve(res)
            self._class(t.priority)["shed"] += 1

    def _evict_sheddable(self) -> bool:
        """Shed the least-urgent sheddable pending column to admit a
        guaranteed one: lowest class first, then the latest deadline,
        then the newest arrival. False if nothing is sheddable."""
        victim_key = None
        worst = (self.shed_priority - 1, -math.inf, -math.inf)
        for k, p in self._pending.items():
            if p.priority < self.shed_priority:
                continue  # guaranteed columns are never evicted
            cand = (p.priority, p.deadline_at, p.submitted_at)
            if cand > worst:
                worst, victim_key = cand, k
        if victim_key is None:
            return False
        p = self._pending.pop(victim_key)
        self.stats["shed_evicted"] += 1
        self._shed(p.tickets, p.roots)
        self._cond.notify_all()
        return True

    def rank_async(self, queries: Sequence[Sequence[int]]) -> List[QueueTicket]:
        return [self.submit(q) for q in queries]

    def flush(self):
        """Dispatch everything pending now (caller's thread), ignoring the
        deadline — the drain a benchmark or shutdown wants. Runs each
        batch depth-1 through the shared pipeline (nothing to overlap
        with on a drain)."""
        while True:
            batch = self._take_batch()
            if not batch:
                return
            with self._cond:
                self.stats["flush_drain"] += 1
            for _out in self.service.pipeline.run([self._job(batch)],
                                                  depth=1):
                pass

    def close(self, wait: bool = True):
        """Stop accepting submissions, drain what's pending, stop the
        dispatcher."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if wait:
            self._thread.join()
            self.flush()  # anything the dispatcher left behind

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._pending)

    # -- dispatcher -------------------------------------------------------

    def _take_batch(self) -> List[_Pending]:
        with self._cond:
            if not self._pending:
                return []
            # EDF: earliest deadline first; deadline-less columns (inf)
            # fall back to arrival order, so the default traffic mix
            # keeps the old FIFO batches exactly
            order = sorted(self._pending, key=lambda k: (
                self._pending[k].deadline_at, self._pending[k].submitted_at))
            batch = [self._pending.pop(k) for k in order[:self.v_max]]
            now = time.perf_counter()
            for p in batch:  # EDF wait: column admission -> dispatch
                self._m_wait.observe((now - p.submitted_at) * 1e3)
            self._cond.notify_all()  # wake backpressured submitters
            return batch

    def _job(self, batch: List[_Pending], backlog: int = 0) -> PipelineJob:
        """One pipeline job for a taken batch; ``on_done`` fans results
        (or the failure) out to every waiting ticket at publish time.

        ``backlog`` is what was still pending after the take: when it
        would fill another whole batch and rank-stability stopping is on,
        the job runs at half the configured ``rank_k`` — coarser rank
        certificates buy fewer sweeps per query under overload.
        """
        job = PipelineJob(queries=[p.roots for p in batch], tag=batch,
                          on_done=self._resolve_job)
        base = int(self.service.cfg.rank_k)
        if base > 0 and backlog >= self.v_max:
            job.rank_k = max(1, base // 2)
            with self._cond:
                self.stats["degraded"] += 1
        return job

    def _resolve_job(self, job: PipelineJob, results, exc):
        batch = job.tag
        if results is None:
            results = [None] * len(batch)
        for p, r in zip(batch, results):
            for t in p.tickets:
                t._resolve(r, exc)
        with self._cond:
            self.stats["batches"] += 1
            self.stats["max_batch"] = max(self.stats["max_batch"],
                                          len(batch))
            for p in batch:
                for t in p.tickets:
                    c = self._class(t.priority)
                    if exc is not None:
                        # a crashing backend must not count as service:
                        # failed tickets get their own counter and stay
                        # out of the latency window (an error in 2ms is
                        # not a 2ms serve) and the deadline-miss ledger
                        c["failed"] += 1
                        continue
                    c["served"] += 1
                    self._lat(c, t)
                    if t.resolved_at > t.deadline_at:
                        self.stats["deadline_miss"] += 1

    def snapshot_stats(self) -> dict:
        """A consistent copy of the queue counters plus per-class
        admission/latency summaries (``classes[priority]`` with
        submitted/served/shed/failed counts and p50/p95 ms over a bounded
        recent window of SERVED tickets only — shed and failed resolutions
        never enter the percentile window)."""
        with self._cond:
            out = dict(self.stats)
            classes = {}
            for pri, c in sorted(self._class_stats.items()):
                classes[pri] = {
                    "submitted": c["submitted"].value,
                    "served": c["served"].value,
                    "shed": c["shed"].value, "failed": c["failed"].value,
                    "p50_ms": c["lat"].percentile(50),
                    "p95_ms": c["lat"].percentile(95)}
            out["classes"] = classes
            return out

    def telemetry_snapshot(self) -> dict:
        """The queue registry's full rendering (``/stats.json`` shape);
        the live pending depth samples into ``queue.pending`` here."""
        with self._cond:
            self.telemetry.gauge("queue.pending").set(len(self._pending))
        return self.telemetry.snapshot()

    def drain(self, flush_spill: bool = True) -> dict:
        """Operator-grade graceful shutdown (the SIGTERM path): stop
        admission, *shed* every still-pending best-effort column
        immediately (their tickets resolve now, ``status="shed"`` — a
        terminating process must not make best-effort callers wait out a
        full drain), serve every guaranteed pending column, then flush
        and generation-GC the service's spill so a successor process
        restarts warm. Returns a summary dict for the shutdown log:
        ``{"shed": tickets shed here, "served": tickets served over the
        queue's lifetime, "spill_flushed": bool, "gc_removed": dirs}``.

        Safe to call more than once (later calls drain nothing new).
        A column counts as best-effort only if *every* coalesced ticket
        on it is (its class is the min over its tickets) — a guaranteed
        submit coalesced onto a sheddable key keeps the column.
        """
        shed_tickets = 0
        with self._cond:
            self._closed = True
            victims = [k for k, p in self._pending.items()
                       if p.priority >= self.shed_priority]
            for k in victims:
                p = self._pending.pop(k)
                shed_tickets += len(p.tickets)
                self._shed(p.tickets, p.roots)
            self._cond.notify_all()
        self._thread.join()   # dispatcher serves the guaranteed pending
        self.flush()          # anything it left behind
        self.telemetry.counter("queue.drains").inc()
        spilled, gc_removed = False, 0
        if flush_spill and self.service._spill is not None:
            self.service.flush_spill()
            gc_removed = self.service.gc_spill()
            spilled = True
        with self._cond:
            served = sum(c["served"].value
                         for c in self._class_stats.values())
        return {"shed": shed_tickets, "served": served,
                "spill_flushed": spilled, "gc_removed": gc_removed}

    def undrain(self) -> bool:
        """Re-open admission after a ``drain()`` (or ``close()``) — the
        second half of a zero-downtime roll: drain, mutate the service
        (``apply_edge_delta``), undrain. Resets the closed flag and starts
        a fresh dispatcher thread (the old one exited at drain); pending
        state is empty by construction, counters and per-class windows
        carry over. Returns True if admission was re-opened, False if the
        queue was already open. Raises if the old dispatcher is still
        draining (a ``close(wait=False)`` not yet finished).
        """
        with self._cond:
            if not self._closed:
                return False
            if self._thread.is_alive():
                raise RuntimeError(
                    "dispatcher still draining; finish drain() or "
                    "close(wait=True) before undrain()")
            self._closed = False
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="rank-queue-dispatch")
            self._thread.start()
        self.telemetry.counter("queue.undrains").inc()
        return True

    def _job_stream(self):
        """The dispatcher's job source: block until a flush criterion —
        v_max distinct pending, the oldest's deadline, or closure — then
        take a batch and yield its job.

        The pipeline pulls this generator from its prepare worker, so at
        depth >= 2 the wait itself runs while the previous batch sweeps
        on the driving thread.
        """
        while True:
            with self._cond:
                while True:
                    if self._pending:
                        n = len(self._pending)
                        now = time.perf_counter()
                        oldest = next(
                            iter(self._pending.values())).submitted_at
                        # flush when EITHER the oldest arrival has waited
                        # out the queue deadline OR a per-request SLA
                        # deadline is within the dispatch margin — the
                        # queue deadline alone would sit a tight-deadline
                        # submit in an otherwise-quiet queue until its SLA
                        # was already blown
                        wait_s = oldest + self.deadline_s - now
                        edl = min(p.deadline_at
                                  for p in self._pending.values())
                        if edl < math.inf:
                            wait_s = min(wait_s, edl - self.margin_s - now)
                        if n >= self.v_max:
                            reason = "flush_vmax"
                            break
                        if self._closed:
                            # shutdown drain of a partial batch — its own
                            # reason, NOT a deadline firing (telemetry
                            # must tell load-driven flushes from drains)
                            reason = "flush_close"
                            break
                        if wait_s <= 0:
                            reason = "flush_deadline"
                            break
                        # coalesces that tighten a deadline_at notify the
                        # cond, so this wait re-derives after them
                        self._cond.wait(wait_s)
                    elif self._closed:
                        return
                    else:
                        self._cond.wait()
            batch = self._take_batch()
            if batch:
                with self._cond:
                    self.stats[reason] += 1
                    backlog = len(self._pending)
                yield self._job(batch, backlog=backlog)

    def _loop(self):
        # drive the job stream through the service's staged pipeline;
        # ticket resolution happens inside publish via on_done
        bind_thread(self.service.device)
        for _out in self.service.pipeline.run(self._job_stream()):
            pass
