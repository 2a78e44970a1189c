"""Query-ranking service launcher: batched multi-query accelerated HITS
with a request-generator load loop (port of ``repro.launch.serve_rank``,
on the card unless ``--device cpu``).

Simulates the serving workload the ROADMAP names: a stream of root-set
queries with Zipf-skewed popularity (popular queries repeat — the cache's
bread and butter), batched V at a time through one traversal. `--frontend
queued` feeds the stream one request at a time through the SLA-aware
micro-batching `RankQueue` (Poisson arrivals via `--arrival-qps`,
priority classes via `--low-pri-frac`, per-request SLAs via `--sla-ms`;
p50/p95 latency reported per class), and `--spill-dir` persists converged
vectors and plans so a relaunch serves the previous run's queries warm.

Ops surface: `--stats-port` serves `GET /healthz` and `GET /stats.json`
(the live telemetry registries) on loopback for probes and scrapers; in
queued mode SIGTERM/SIGINT triggers a graceful drain — admission stops,
pending best-effort requests resolve as shed, guaranteed pending requests
are served, the spill is flushed and generation-GC'd
(`--spill-keep-generations`), and the process exits 0; SIGHUP (with
`--delta-file`) rolls an edge changeset in without a restart — drain,
`apply_edge_delta`, undrain — so guaranteed traffic never drops across a
graph mutation.

  PYTHONPATH=src python -m repro_torch.launch.serve_rank --dataset \
      britannica --scale 1.0 --backend bsr --requests 200 --v 8
  PYTHONPATH=src python -m repro_torch.launch.serve_rank --device cpu \
      --dataset synthetic --n-nodes 3000 --n-edges 24000 --frontend queued \
      --arrival-qps 100 --deadline-ms 5 --spill-dir /tmp/rank_spill \
      --stats-port 0
  PYTHONPATH=src python -m repro_torch.launch.serve_rank --device cpu \
      --dataset synthetic --n-nodes 3000 --n-edges 24000 --backend sharded \
      --shard-mode dual_blocked --shard-devices 4
"""
from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

import numpy as np


def load_delta_file(path: str) -> dict:
    """Parse a JSON edge-changeset spec: ``{"adds": [[s, d, w?], ...],
    "removes": [[s, d], ...], "reweights": [[s, d, w], ...]}`` (all keys
    optional). Validation of ids/weights happens in ``apply_edge_delta``."""
    import json
    with open(path) as f:
        spec = json.load(f)
    unknown = set(spec) - {"adds", "removes", "reweights"}
    if unknown:
        raise ValueError(f"delta file {path}: unknown keys "
                         f"{sorted(unknown)}")
    return {k: spec.get(k) for k in ("adds", "removes", "reweights")}


def roll_delta(svc, q, delta: dict, draining=None):
    """Zero-downtime edge-delta roll: drain -> swap -> undrain.

    Stops admission and serves every guaranteed pending request
    (``q.drain`` — best-effort pending resolves as shed, nothing
    guaranteed is dropped), applies the edge changeset while the service
    is quiescent, then re-opens admission (``q.undrain``). ``draining``
    (an optional threading.Event) is held set for the duration so
    ``/healthz`` reports the roll. Returns (drain_summary,
    delta_summary)."""
    if draining is not None:
        draining.set()
    try:
        d = q.drain(flush_spill=True)
        s = svc.apply_edge_delta(adds=delta.get("adds"),
                                 removes=delta.get("removes"),
                                 reweights=delta.get("reweights"))
        q.undrain()
    finally:
        if draining is not None:
            draining.clear()
    return d, s


def zipf_query_stream(rng, n_nodes: int, n_queries: int, roots_per_query: int,
                      vocab: int = 64, alpha: float = 1.3):
    """A stream of root sets drawn from a Zipf-popular query vocabulary.

    ``vocab`` distinct queries exist; request i picks one by Zipf rank, so
    head queries recur (exact cache hits) and the rest share popular roots
    (warm-start overlap) — the regime a production ranking cache sees.
    """
    vocab_sets = [rng.choice(n_nodes, size=roots_per_query, replace=False)
                  for _ in range(vocab)]
    ranks = np.arange(1, vocab + 1, dtype=np.float64) ** (-alpha)
    p = ranks / ranks.sum()
    picks = rng.choice(vocab, size=n_queries, p=p)
    return [vocab_sets[i] for i in picks]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wikipedia",
                    help="paper dataset name or 'synthetic'")
    ap.add_argument("--scale", type=float, default=0.5)
    ap.add_argument("--n-nodes", type=int, default=10000)
    ap.add_argument("--n-edges", type=int, default=80000)
    ap.add_argument("--dangling", type=float, default=0.6)
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--roots", type=int, default=5)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--v", type=int, default=8, help="batch width (columns)")
    ap.add_argument("--tol", type=float, default=1e-10)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the service runs: cuda (the card) or cpu")
    from ..configs.hits_webgraph import CONFIG
    ap.add_argument("--backend", default=CONFIG.serve_backend,
                    choices=["dense", "sharded", "bsr", "auto"],
                    help="sweep backend (see repro_torch.serve.backends)")
    ap.add_argument("--shard-mode", default=CONFIG.serve_shard_mode,
                    choices=["replicated", "dual_blocked"],
                    help="sharded backend edge-shard strategy")
    ap.add_argument("--shard-devices", type=int, default=None,
                    help="sharded backend shard count (default: every "
                         "visible device; more shards than devices share "
                         "them round-robin)")
    ap.add_argument("--plan-cache", type=int,
                    default=CONFIG.serve_plan_cache,
                    help="SweepPlan LRU entries (structural layouts cached "
                         "per union-subgraph hash; 0 disables)")
    ap.add_argument("--bsr-host-loop", action="store_true",
                    default=not CONFIG.serve_bsr_fused,
                    help="bsr: host-driven convergence loop instead of the "
                         "on-device loop (one CUDA graph per batch)")
    ap.add_argument("--pipeline-depth", type=int,
                    default=CONFIG.serve_pipeline_depth,
                    help="staged-dispatch batches in flight (1: serial; "
                         ">=2: overlap host assemble/plan with the "
                         "previous batch's device sweep)")
    ap.add_argument("--sweep-dtype", default=CONFIG.serve_sweep_dtype,
                    help="precision ladder: run bulk sweeps at this dtype "
                         "(bf16|fp32|f64), then f64-polish to tol with a "
                         "residual certificate ('': single-phase)")
    ap.add_argument("--polish-tol", type=float,
                    default=CONFIG.serve_polish_tol,
                    help="precision ladder polish tolerance (0: the "
                         "configured --tol)")
    ap.add_argument("--lumping", default=CONFIG.serve_lumping,
                    choices=["off", "on", "auto"],
                    help="plan-time lumped sweep reduction: drop isolated "
                         "union rows + collapse duplicate-pattern classes "
                         "before planning/sweeping (auto: only above the "
                         "reduction-ratio gate)")
    ap.add_argument("--rank-k", type=int, default=CONFIG.serve_rank_k,
                    help="rank-stability early exit: stop a column once its "
                         "top-k authority ordering holds stable (0: exact "
                         "residual stopping)")
    ap.add_argument("--stable-sweeps", type=int,
                    default=CONFIG.serve_stable_sweeps,
                    help="consecutive stable sweeps required to early-exit")
    ap.add_argument("--frontend", default="sync",
                    choices=["sync", "queued"],
                    help="sync: pre-built v_max chunks; queued: async "
                         "micro-batching RankQueue fed one request at a time")
    ap.add_argument("--arrival-qps", type=float, default=0.0,
                    help="queued: Poisson arrival rate (0: back-to-back)")
    ap.add_argument("--deadline-ms", type=float,
                    default=CONFIG.serve_deadline_ms,
                    help="queued: max extra batching latency per request")
    ap.add_argument("--queue-depth", type=int,
                    default=CONFIG.serve_queue_depth or None,
                    help="queued: max distinct pending root sets")
    ap.add_argument("--sla-ms", type=float, default=0.0,
                    help="queued: per-request deadline for EDF batching and "
                         "deadline-miss accounting (0: none)")
    ap.add_argument("--low-pri-frac", type=float, default=0.0,
                    help="queued: fraction of requests submitted at the "
                         "best-effort class (sheddable under overload)")
    ap.add_argument("--shed-priority", type=int,
                    default=CONFIG.serve_shed_priority,
                    help="queued: lowest priority class still guaranteed is "
                         "shed_priority-1; classes >= this may shed")
    ap.add_argument("--spill-dir", default=CONFIG.serve_spill_dir or None,
                    help="cache spill directory (restart-survivable cache)")
    ap.add_argument("--spill-policy", default=CONFIG.serve_spill_policy,
                    choices=["all", "evict"])
    ap.add_argument("--spill-keep-generations", type=int,
                    default=CONFIG.serve_spill_keep_generations,
                    help="spill GC: newest step_* generations kept per "
                         "entry stream (compacted at init and on drain)")
    ap.add_argument("--delta-file", default=None,
                    help="JSON edge changeset ({adds: [[s,d,w?]..], "
                         "removes: [[s,d]..], reweights: [[s,d,w]..]}); "
                         "queued frontend applies it on SIGHUP via a "
                         "zero-downtime drain -> swap -> undrain roll")
    ap.add_argument("--stats-port", type=int,
                    default=(CONFIG.serve_stats_port
                             if CONFIG.serve_stats_port >= 0 else None),
                    help="serve GET /healthz and /stats.json on this "
                         "loopback port (0: ephemeral, printed at start; "
                         "omit to disable)")
    args = ap.parse_args()

    from ..graph import WebGraphSpec, generate_webgraph, paper_dataset
    from ..serve import RankService, RankServiceConfig

    if args.dataset == "synthetic":
        g = generate_webgraph(WebGraphSpec(args.n_nodes, args.n_edges,
                                           args.dangling, seed=args.seed))
    else:
        g = paper_dataset(args.dataset, scale=args.scale)
    print(f"graph: N={g.n_nodes} E={g.n_edges} "
          f"dangling={g.dangling_fraction():.1%}")

    def cfg(spill=args.spill_dir):
        return RankServiceConfig(v_max=args.v, tol=args.tol,
                                 backend=args.backend,
                                 shard_mode=args.shard_mode,
                                 shard_devices=args.shard_devices,
                                 device=args.device,
                                 plan_cache_size=args.plan_cache,
                                 bsr_fused=not args.bsr_host_loop,
                                 pipeline_depth=args.pipeline_depth,
                                 sweep_dtype=args.sweep_dtype,
                                 polish_tol=args.polish_tol or None,
                                 lumping=args.lumping,
                                 rank_k=args.rank_k,
                                 stable_sweeps=args.stable_sweeps,
                                 deadline_ms=args.deadline_ms,
                                 queue_depth=args.queue_depth,
                                 shed_priority=args.shed_priority,
                                 spill_dir=spill,
                                 spill_policy=args.spill_policy,
                                 spill_keep_generations=args
                                 .spill_keep_generations)

    svc = RankService(g, cfg())
    if args.spill_dir and svc.stats["spill_restored"]:
        print(f"spill: restored {svc.stats['spill_restored']} cache entries "
              f"from {args.spill_dir}")
    rng = np.random.default_rng(args.seed)
    stream = zipf_query_stream(rng, g.n_nodes, args.requests, args.roots,
                               vocab=args.vocab)

    # build the kernels and warm the card so the loop measures serving
    # (on a fresh service so the measured run's cache starts cold)
    RankService(g, cfg(spill=None)).rank(stream[: args.v])

    # ops surface: loopback health/stats endpoint + graceful drain state
    live_q = [None]  # the queued frontend parks its RankQueue here
    draining = threading.Event()
    stats_srv = None
    if args.stats_port is not None:
        from ..serve.telemetry import StatsServer

        def _stats():
            out = {"service": svc.telemetry_snapshot(),
                   "pipeline_depth": args.pipeline_depth}
            q = live_q[0]
            if q is not None:
                out["queue"] = q.telemetry_snapshot()
            return out

        def _health():
            if draining.is_set():
                return False, "draining"
            return True, "ok"

        stats_srv = StatsServer(_stats, _health, port=args.stats_port)
        print(f"stats: GET /healthz /stats.json on "
              f"127.0.0.1:{stats_srv.port}", flush=True)

    lat = None
    drain_line = None
    if args.frontend == "queued":
        stop = threading.Event()
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, lambda *_: stop.set())
        # SIGHUP rolls the --delta-file changeset in without a restart:
        # drain -> apply_edge_delta -> undrain
        roll = threading.Event()
        delta_spec = (load_delta_file(args.delta_file)
                      if args.delta_file else None)
        if delta_spec is not None and hasattr(signal, "SIGHUP"):
            signal.signal(signal.SIGHUP, lambda *_: roll.set())
        # one request at a time through the micro-batching queue, Poisson
        # inter-arrivals — the live-traffic regime the sync path can't see
        gaps = (rng.exponential(1.0 / args.arrival_qps, len(stream))
                if args.arrival_qps > 0 else np.zeros(len(stream)))
        t0 = time.time()
        sla = args.sla_ms or None
        with svc.queue() as q:
            live_q[0] = q
            print(f"serving: queued frontend accepting "
                  f"{len(stream)} requests", flush=True)
            tickets = []
            for roots, gap in zip(stream, gaps):
                if stop.is_set():
                    break
                if roll.is_set():
                    roll.clear()
                    d, ds = roll_delta(svc, q, delta_spec, draining)
                    print(f"delta roll: drained ({d['served']} served, "
                          f"{d['shed']} best-effort shed), "
                          f"{ds['invalidated']} cache entries invalidated, "
                          f"structural={ds['structural']}, swap "
                          f"{ds['swap_ms']:.1f}ms, admission re-opened",
                          flush=True)
                if gap:
                    time.sleep(gap)
                pri = (args.shed_priority
                       if rng.uniform() < args.low_pri_frac else 0)
                tickets.append(q.submit(roots, priority=pri,
                                        deadline_ms=sla))
            if stop.is_set():
                # SIGTERM/SIGINT: stop admission, shed best-effort
                # pending with status, serve guaranteed pending, flush
                # + GC the spill — then exit 0 below like a normal run
                draining.set()
                d = q.drain()
                drain_line = (
                    f"drain: admission stopped after {len(tickets)} "
                    f"submits, {d['shed']} best-effort shed, "
                    f"{d['served']} served, spill "
                    f"{'flushed' if d['spill_flushed'] else 'skipped'} "
                    f"(gc removed {d['gc_removed']})")
                print(drain_line, flush=True)
            results = [t.result(timeout=600) for t in tickets]
        dt = time.time() - t0
        lat = np.array([t.latency_s for t in tickets]) * 1e3
        qs = q.snapshot_stats()
        print(f"queue: {qs['batches']} batches "
              f"(vmax {qs['flush_vmax']} / deadline {qs['flush_deadline']} "
              f"/ drain {qs['flush_drain']} / close {qs['flush_close']}), "
              f"{qs['coalesced']} coalesced, max width {qs['max_batch']}")
        print(f"sla: {qs['shed']} shed ({qs['shed_evicted']} evicted) / "
              f"{qs['deadline_miss']} deadline misses / "
              f"{qs['degraded']} degraded batches")
        for pri, c in qs["classes"].items():
            p50 = "-" if c["p50_ms"] is None else f"{c['p50_ms']:.1f}ms"
            p95 = "-" if c["p95_ms"] is None else f"{c['p95_ms']:.1f}ms"
            print(f"  class {pri}: {c['submitted']} submitted / "
                  f"{c['served']} served / {c['shed']} shed, "
                  f"p50 {p50} p95 {p95}")
    else:
        t0 = time.time()
        results = svc.rank(stream)
        dt = time.time() - t0

    s = svc.snapshot_stats()
    iters = [r.iters for r in results if r.iters > 0]
    print(f"served {len(results)} queries in {dt:.2f}s "
          f"({len(results) / dt:.1f} q/s, batch width {args.v}, "
          f"backend {args.backend}: {s['backend_batches']})")
    print(f"cache: {s['hit']} hits / {s['warm']} warm / {s['cold']} cold "
          f"({s['hit'] / max(s['queries'], 1):.1%} hit rate)")
    # restored plans skipped a rebuild just like hits did
    reused = s["plan_hits"] + s["plan_restored"]
    pt = reused + s["plan_misses"]
    print(f"plans: {s['plan_hits']} hits / {s['plan_misses']} built / "
          f"{s['plan_restored']} restored / {s['plan_evictions']} evicted "
          f"({reused / max(pt, 1):.1%} plan reuse rate, "
          f"cache {'off' if args.plan_cache <= 0 else args.plan_cache})")
    ps = svc.pipeline.stats
    print(f"pipeline: depth {args.pipeline_depth}, {ps['jobs']} jobs / "
          f"{ps['swept']} swept, "
          f"{svc.pipeline.overlap_events()} overlapped assembles")
    if lat is not None and lat.size:
        print(f"latency: p50 {np.percentile(lat, 50):.1f}ms "
              f"p95 {np.percentile(lat, 95):.1f}ms max {lat.max():.1f}ms")
    if args.spill_dir:
        print(f"spill: {s['spill_writes']} writes / {s['spill_hits']} disk "
              f"hits -> {args.spill_dir} (restart me to serve them warm)")
    if iters:
        print(f"iterated queries: mean {np.mean(iters):.1f} sweeps, "
              f"max {max(iters)}")
    if args.sweep_dtype:
        certs = [r.residual for r in results if r.residual is not None]
        if certs:
            print(f"precision ladder ({args.sweep_dtype} bulk): residual "
                  f"certificates max {max(certs):.2e} over "
                  f"{len(certs)} certified results")
    if results:
        r = results[-1]
        cert = "" if r.residual is None else f" res={r.residual:.1e}"
        print(f"sample query {r.roots.tolist()} [{r.status}{cert}]: "
              f"top-{args.topk} authorities {r.topk(args.topk)}")
    if stats_srv is not None:
        stats_srv.close()
    if drain_line is not None:
        sys.exit(0)  # a drained run is a successful run


if __name__ == "__main__":
    main()
