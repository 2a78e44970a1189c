"""The port's async micro-batching frontend (``serve/queue.py``:
``RankQueue`` and ``RankService.queue()``) on the CPU, mirroring the
deterministic cases of ``tests/test_serve_queue.py``: flush rules,
coalescing, validation at submit, backpressure, EDF order, shedding only
best-effort work, backlog ``rank_k`` degradation, failed dispatches,
drain and undrain, and queued == sync, with the reference's queue and
service as the oracle where the two can be compared.

No test bounds a wall time; every ticket wait and thread join has a
timeout (``WAIT``), so a hang fails the test instead of the run.
"""
import math
import sys
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from repro.graph import WebGraphSpec, generate_webgraph
from repro.graph import root_set_key as ref_root_set_key
from repro.serve import RankService as RefService
from repro.serve import RankServiceConfig as RefConfig
from repro_torch.graph import from_reference, root_set_key
from repro_torch.serve import RankService, RankServiceConfig

TOL = 1e-12
WAIT = 120  # seconds any ticket or join may take before the test fails


@pytest.fixture(scope="module")
def rg():
    return generate_webgraph(WebGraphSpec(1200, 9000, 0.5, seed=4))


@pytest.fixture(scope="module")
def g(rg):
    return from_reference(rg)


@pytest.fixture(scope="module")
def queries(rg):
    rng = np.random.default_rng(6)
    return [rng.choice(rg.n_nodes, size=4, replace=False) for _ in range(8)]


def svc_for(g, **kw):
    kw.setdefault("v_max", 4)
    kw.setdefault("tol", TOL)
    return RankService(g, RankServiceConfig(device="cpu", **kw))


def close(q):
    """``q.close()`` with a bounded wait for the dispatcher thread."""
    q.close(wait=False)
    q._thread.join(timeout=WAIT)
    assert not q._thread.is_alive(), "the dispatcher did not stop"
    q.flush()


@contextmanager
def opened(svc, **kw):
    q = svc.queue(**kw)
    try:
        yield q
    finally:
        close(q)


def results(tickets):
    return [t.result(timeout=WAIT) for t in tickets]


# ------------------------------------------------------------ flush rules


def test_vmax_flush_does_not_wait_for_deadline(g, queries):
    """v_max distinct pending root sets dispatch at once: the batch is
    flushed by width, never by the (minute-long) deadline."""
    svc = svc_for(g)
    with opened(svc, deadline_ms=60_000) as q:
        res = results([q.submit(x) for x in queries[:4]])
    assert q.stats["flush_vmax"] == 1 and q.stats["flush_deadline"] == 0
    assert q.stats["max_batch"] == 4
    assert [r.status for r in res] == ["cold"] * 4


def test_deadline_flush_dispatches_partial_batch(g, queries):
    svc = svc_for(g)
    with opened(svc, deadline_ms=30) as q:
        tickets = [q.submit(x) for x in queries[:2]]
        res = results(tickets)
    assert q.stats["flush_deadline"] == 1 and q.stats["flush_vmax"] == 0
    assert [r.status for r in res] == ["cold"] * 2
    # a lower bound only: each ticket waited (about) the deadline
    assert all(t.latency_s >= 0.02 for t in tickets)


def test_close_drains_pending(g, queries):
    svc = svc_for(g)
    q = svc.queue(deadline_ms=60_000)
    tickets = [q.submit(x) for x in queries[:2]]
    close(q)
    assert all(t.done() for t in tickets)
    assert all(r.status == "cold" for r in results(tickets))
    with pytest.raises(RuntimeError):
        q.submit(queries[0])
    assert q.stats["flush_close"] == 1
    assert q.stats["flush_deadline"] == 0 and q.stats["flush_vmax"] == 0


# ------------------------------------------------------------- coalescing


@pytest.mark.parametrize("port", [False, True])
def test_duplicate_root_sets_coalesce_in_flight(rg, g, queries, port):
    """The same root set submitted while pending occupies one column and
    every ticket gets the same result; the reference's queue counts the
    same."""
    svc = (svc_for(g) if port else
           RefService(rg, RefConfig(v_max=4, tol=TOL)))
    roots = list(queries[0])
    q = svc.queue(deadline_ms=60_000)
    try:
        t1 = q.submit(roots)
        t2 = q.submit(list(reversed(roots)))
        t3 = q.submit(roots + [int(roots[0])])
        assert q.depth == 1
        rest = [q.submit(x) for x in queries[1:4]]
        res = results([t1, t2, t3])
        results(rest)
    finally:
        close(q)
    assert res[0] is res[1] is res[2]
    assert (q.stats["coalesced"], q.stats["submitted"], q.stats["flush_vmax"],
            svc.stats["queries"]) == (2, 6, 1, 4)


def test_coalesced_key_matches_root_set_key(g, queries):
    svc = svc_for(g)
    with opened(svc, deadline_ms=20) as q:
        t = q.submit(queries[0])
        assert t.key == root_set_key(queries[0]) == \
            ref_root_set_key(queries[0])
        t.result(timeout=WAIT)


# ------------------------------------------------- validation/backpressure


def test_invalid_roots_raise_at_submit_not_dispatch(g, queries):
    svc = svc_for(g)
    with opened(svc, deadline_ms=30) as q:
        good = q.submit(queries[0])
        for bad in ([], [-1], [g.n_nodes], [1.5]):
            with pytest.raises(ValueError):
                q.submit(bad)
        assert good.result(timeout=WAIT).status == "cold"
    assert q.stats["submitted"] == 1


def test_backpressure_bounds_distinct_pending(g):
    svc = svc_for(g, v_max=2)
    rng = np.random.default_rng(9)
    qs = [rng.choice(g.n_nodes, size=3, replace=False) for _ in range(8)]
    with opened(svc, deadline_ms=5, max_pending=2) as q:
        tickets = [q.submit(x) for x in qs]  # blocks transiently
        assert all(r is not None for r in results(tickets))
    assert q.stats["max_batch"] <= 2
    with pytest.raises(ValueError):
        svc.queue(max_pending=0)


# ------------------------------------------------------- SLA admission


def _stall_dispatcher(q, filler):
    """Under the held sweep lock: feed the dispatcher a filler batch so it
    blocks mid-sweep, leaving the pending set to the test."""
    tickets = [q.submit(x) for x in filler]
    deadline = time.perf_counter() + WAIT
    while q.depth > 0:
        assert time.perf_counter() < deadline, "dispatcher never took filler"
        time.sleep(0.002)
    return tickets


def test_edf_takes_most_urgent_batch_first(g, queries):
    svc = svc_for(g, pipeline_depth=1, v_max=2)
    with opened(svc, deadline_ms=60_000, max_pending=8) as q:
        with svc.pipeline._sweep_lock:
            _stall_dispatcher(q, queries[:2])
            a = q.submit(queries[2])                    # oldest, no deadline
            b = q.submit(queries[3], deadline_ms=50)
            c = q.submit(queries[4], deadline_ms=100)
            time.sleep(0.06)  # stall past b's SLA: a deterministic miss
        rb, rc = b.result(timeout=WAIT), c.result(timeout=WAIT)
    ra = a.result(timeout=WAIT)
    assert rb.status == rc.status == ra.status == "cold"
    assert b.resolved_at < a.resolved_at and c.resolved_at < a.resolved_at
    assert q.stats["batches"] == 3
    assert q.stats["deadline_miss"] >= 1


def test_overload_sheds_best_effort_never_guaranteed(g):
    rng = np.random.default_rng(21)
    qs = [rng.choice(g.n_nodes, size=3, replace=False) for _ in range(8)]
    svc = svc_for(g, pipeline_depth=1, v_max=2)
    q = svc.queue(deadline_ms=60_000, max_pending=2, shed_priority=1)
    try:
        with svc.pipeline._sweep_lock:
            fill = _stall_dispatcher(q, qs[:2])
            b = q.submit(qs[2], priority=1, deadline_ms=50)
            c = q.submit(qs[3], priority=1)          # pending now full
            d = q.submit(qs[4], priority=1)          # best-effort: sheds
            assert d.done() and d.result().status == "shed"
            assert d.result().iters == 0
            assert np.array_equal(d.result().authority, np.zeros(3))
            e = q.submit(qs[5], priority=0)          # guaranteed: evicts c
            assert c.done() and c.result().status == "shed"
            assert not b.done() and not e.done()
            assert q.depth == 2
            time.sleep(0.06)
        served = results([b, e, *fill])
    finally:
        close(q)
    assert all(r.status == "cold" for r in served)
    assert q.stats["shed"] == 2 and q.stats["shed_evicted"] == 1
    cls = q.snapshot_stats()["classes"]
    assert cls[1]["shed"] == 2 and cls[0]["shed"] == 0
    assert cls[0]["served"] == 3 and cls[1]["served"] == 1
    assert cls[0]["p95_ms"] is not None
    assert q.stats["deadline_miss"] >= 1


def test_backlog_degrades_rank_k(g):
    """A post-take backlog that fills another batch halves the dispatched
    rank_k (counted as degraded), and nothing is shed."""
    rng = np.random.default_rng(23)
    qs = [rng.choice(g.n_nodes, size=3, replace=False) for _ in range(8)]
    svc = svc_for(g, pipeline_depth=1, v_max=2, rank_k=4)
    q = svc.queue(deadline_ms=60_000, max_pending=8)
    try:
        with svc.pipeline._sweep_lock:
            fill = _stall_dispatcher(q, qs[:2])
            rest = [q.submit(x) for x in qs[2:8]]    # 6 pending > v_max
        got = results([*fill, *rest])
    finally:
        close(q)
    assert q.stats["degraded"] >= 1 and q.stats["shed"] == 0
    assert all(r is not None and r.status == "cold" for r in got)


def test_failed_dispatch_not_counted_served(g, queries):
    svc = svc_for(g)

    def boom(asm):
        raise RuntimeError("device fell over")

    svc.pipeline.sweep = boom
    with opened(svc, deadline_ms=10) as q:
        t = q.submit(queries[0], deadline_ms=1)
        time.sleep(0.01)
        with pytest.raises(RuntimeError, match="device fell over"):
            t.result(timeout=WAIT)
    cls = q.snapshot_stats()["classes"][0]
    assert cls["failed"] == 1 and cls["served"] == 0
    assert cls["p50_ms"] is None and cls["p95_ms"] is None
    assert q.stats["deadline_miss"] == 0


def test_shed_tickets_do_not_pollute_latency_percentiles(g):
    rng = np.random.default_rng(29)
    qs = [rng.choice(g.n_nodes, size=3, replace=False) for _ in range(10)]
    svc = svc_for(g, pipeline_depth=1, v_max=2)
    q = svc.queue(deadline_ms=60_000, max_pending=2, shed_priority=1)
    try:
        with svc.pipeline._sweep_lock:
            _stall_dispatcher(q, qs[:2])
            a = q.submit(qs[2], priority=1)
            b = q.submit(qs[3], priority=1)          # pending now full
            shed = [q.submit(x, priority=1) for x in qs[4:10]]
            assert all(t.done() and t.result().status == "shed"
                       for t in shed)
        served = results([a, b])
    finally:
        close(q)
    assert all(r.status == "cold" for r in served)
    cls = q.snapshot_stats()["classes"][1]
    assert cls["served"] == 2 and cls["shed"] == 6
    lo = min(a.latency_s, b.latency_s) * 1e3
    hi = max(a.latency_s, b.latency_s) * 1e3
    assert cls["p50_ms"] >= lo - 1e-6 and cls["p95_ms"] <= hi + 1e-6


def test_submit_deadline_ms_zero_is_an_immediate_deadline(g, queries):
    svc = svc_for(g)
    roots = queries[0]
    svc.rank([roots])  # pre-converged: the dispatch is a pure cache hit
    with opened(svc, deadline_ms=60_000) as q:
        t0 = time.perf_counter()
        t = q.submit(roots, deadline_ms=0)
        assert math.isfinite(t.deadline_at) and t.deadline_at <= t0 + 0.5
        assert t.result(timeout=WAIT).status == "hit"
    assert q.stats["flush_deadline"] == 1
    assert q.stats["deadline_miss"] == 1
    with opened(svc, deadline_ms=10) as q2:
        assert q2.submit(roots).deadline_at == math.inf


# -------------------------------------------------- drain and undrain


def test_undrain_reopens_admission_without_sheds(g, queries):
    svc = svc_for(g)
    with opened(svc, deadline_ms=10) as q:
        before = [q.submit(x) for x in queries[:2]]
        d = q.drain(flush_spill=False)
        assert d["spill_flushed"] is False
        with pytest.raises(RuntimeError, match="draining|closed"):
            q.submit(queries[2])
        assert q.undrain() is True and q.undrain() is False
        after = [q.submit(x) for x in queries[2:4]]
        res = results(before + after)
    assert all(r.status in ("cold", "warm", "hit") for r in res)
    assert q.telemetry_snapshot()["queue.undrains"] == 1
    cls = q.snapshot_stats()["classes"][0]
    assert cls["shed"] == 0 and cls["served"] == 4


def test_drain_sheds_best_effort_serves_guaranteed_flushes_spill(
        tmp_path, g, queries):
    """drain(): pending best-effort columns resolve shed, guaranteed ones
    are served, and the spill is flushed (and GC'd) for a successor, which
    restores every served entry."""
    svc = svc_for(g, pipeline_depth=1, spill_dir=str(tmp_path),
                  spill_policy="evict")
    q = svc.queue(deadline_ms=60_000, max_pending=8)
    with svc.pipeline._sweep_lock:
        fill = _stall_dispatcher(q, queries[:4])
        keep = q.submit(queries[4], priority=0)
        drop = q.submit(queries[5], priority=1)
        box = {}
        th = threading.Thread(target=lambda: box.update(d=q.drain()))
        th.start()
        deadline = time.perf_counter() + WAIT
        while not drop.done():
            assert time.perf_counter() < deadline, "drain never shed"
            time.sleep(0.002)
    th.join(timeout=WAIT)
    assert not th.is_alive(), "drain did not finish"
    d = box["d"]
    assert drop.result().status == "shed"
    assert keep.result(timeout=WAIT).status == "cold"
    assert all(r.status == "cold" for r in results(fill))
    assert d["shed"] == 1 and d["served"] == 5 and d["spill_flushed"]
    assert q.telemetry_snapshot()["queue.drains"] == 1
    succ = svc_for(g, spill_dir=str(tmp_path))
    assert succ.stats["spill_restored"] == 5


# -------------------------------------------------- queued == sync parity


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_queued_matches_sync_and_the_reference(rg, g, queries, backend):
    """The same stream through the queue and through sync rank(), and
    through the reference's sync service: identical node sets, scores
    within 1e-10 L1."""
    kw = dict(backend=backend, bsr_block=64)
    ref = RefService(rg, RefConfig(v_max=4, tol=TOL, **kw)).rank(queries)
    sync = svc_for(g, **kw).rank(queries)
    svc = svc_for(g, **kw)
    with opened(svc, deadline_ms=10) as q:
        got = results(q.rank_async(queries))
    for a, b, c in zip(got, sync, ref):
        assert (a.nodes == b.nodes).all() and (a.nodes == c.nodes).all()
        for o in (b, c):
            assert np.abs(a.authority - o.authority).sum() <= 1e-10
            assert np.abs(a.hub - o.hub).sum() <= 1e-10
    assert set(svc.stats["backend_batches"]) == {backend}


def test_randomized_burst_duplicate_heavy(g):
    """A multi-threaded, duplicate-heavy burst through a tight pending
    bound and a 1-entry vector cache drains without deadlock, recycles a
    plan (3 vocabulary root sets under v_max=2 admit at most 9 unions) and
    resolves every ticket to the sync path's scores (both vectors).

    The reference's draw (78 picks) and its assertions
    (``tests/test_serve_queue.py::test_randomized_burst_duplicate_heavy_stress``):
    every swept batch built or hit a plan, at least one plan was recycled,
    at most one build per distinct union."""
    rng = np.random.default_rng(11)
    vocab = [rng.choice(g.n_nodes, size=4, replace=False) for _ in range(3)]
    picks = [vocab[i] for i in rng.integers(0, len(vocab), 78)]
    ref = {root_set_key(q): r for q, r in zip(vocab, svc_for(g).rank(vocab))}
    svc = svc_for(g, v_max=2, cache_size=1)
    tickets, errs = [], []
    lock = threading.Lock()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the threads often
    try:
        with opened(svc, deadline_ms=2, max_pending=2) as q:
            res = burst(q, picks, tickets, errs, lock)
    finally:
        sys.setswitchinterval(switch)
    assert not errs, errs
    assert len(res) == len(picks)
    for r in res:
        o = ref[r.key]
        assert (r.nodes == o.nodes).all()
        assert np.abs(r.authority - o.authority).sum() <= 1e-10
        assert np.abs(r.hub - o.hub).sum() <= 1e-10
    s = svc.stats
    assert 1 <= s["plan_hits"] + s["plan_misses"] <= s["batches"], s
    assert s["plan_hits"] >= 1, (s, q.stats)
    assert s["plan_misses"] <= 9, s
    assert q.stats["max_batch"] <= 2


def burst(q, picks, tickets, errs, lock):
    """Six client threads submitting ``picks`` with random gaps; returns
    every ticket's result."""
    def client(worker):
        crng = np.random.default_rng(100 + worker)
        for x in picks[worker::6]:
            time.sleep(float(crng.uniform(0, 2e-3)))
            try:
                t = q.submit(x)
                with lock:
                    tickets.append(t)
            except Exception as e:  # noqa: BLE001 — surfaced by the caller
                with lock:
                    errs.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT)
        assert not t.is_alive(), "submitter deadlocked at backpressure"
    return results(tickets)
