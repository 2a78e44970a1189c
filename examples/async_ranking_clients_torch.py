"""Concurrent clients against the async ranking frontend, end to end:

N client threads each submit a stream of Zipf-popular root-set queries to
one shared ``RankQueue``; submissions micro-batch (v_max columns or the
deadline, whichever first), duplicate root sets in flight coalesce into
one column, and converged vectors spill through ``checkpoint.checkpoint``
— so the "restarted" service at the end serves yesterday's queries from
disk without re-iterating. The PyTorch port of the reference's
``examples/async_ranking_clients.py`` (same sizes and lines), on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/async_ranking_clients_torch.py [--device cpu]
"""
import argparse
import shutil
import tempfile
import threading
import time

import numpy as np

from repro_torch.graph import WebGraphSpec, generate_webgraph
from repro_torch.launch.serve_rank import zipf_query_stream
from repro_torch.serve import RankService, RankServiceConfig

N_CLIENTS = 4
QUERIES_PER_CLIENT = 12


def client(name, queue, stream, gaps, latencies):
    tickets = []
    for roots, gap in zip(stream, gaps):
        time.sleep(gap)
        tickets.append(queue.submit(roots))  # open loop: don't wait to send
    for t in tickets:  # a client blocks on its own tickets only
        t.result(timeout=300)
        latencies.append((name, t.latency_s * 1e3))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    g = generate_webgraph(WebGraphSpec(4000, 32000, 0.5, seed=0))
    print(f"graph: N={g.n_nodes} E={g.n_edges}")
    spill_dir = tempfile.mkdtemp(prefix="rank_spill_")

    cfg = RankServiceConfig(v_max=8, tol=1e-10, deadline_ms=10.0,
                            spill_dir=spill_dir, device=dev)
    svc = RankService(g, cfg)
    rng = np.random.default_rng(1)

    latencies = []
    t0 = time.time()
    with svc.queue() as q:
        threads = []
        for c in range(N_CLIENTS):
            # shared Zipf vocabulary: clients repeat each other's queries,
            # so coalescing and the cache both get real work
            stream = zipf_query_stream(np.random.default_rng(100 + c),
                                       g.n_nodes, QUERIES_PER_CLIENT, 4,
                                       vocab=16)
            gaps = rng.exponential(0.01, QUERIES_PER_CLIENT)
            th = threading.Thread(target=client, args=(f"client{c}", q,
                                                       stream, gaps,
                                                       latencies))
            th.start()
            threads.append(th)
        for th in threads:
            th.join()
    wall = time.time() - t0

    n = N_CLIENTS * QUERIES_PER_CLIENT
    lat = np.array([ms for _c, ms in latencies])
    s, qs = svc.stats, q.stats
    print(f"\n{n} queries from {N_CLIENTS} concurrent clients in "
          f"{wall:.2f}s ({n / wall:.0f} q/s)")
    print(f"queue: {qs['batches']} dispatches (vmax {qs['flush_vmax']} / "
          f"deadline {qs['flush_deadline']} / drain {qs['flush_drain']}), "
          f"{qs['coalesced']} coalesced in flight, "
          f"max width {qs['max_batch']}")
    print(f"cache: {s['hit']} hits / {s['warm']} warm / {s['cold']} cold")
    print(f"latency: p50 {np.percentile(lat, 50):.1f}ms "
          f"p95 {np.percentile(lat, 95):.1f}ms")

    # ---- "restart": a fresh process would see exactly this ----
    svc2 = RankService(g, cfg)
    popular = zipf_query_stream(np.random.default_rng(100), g.n_nodes,
                                4, 4, vocab=16)
    r = svc2.rank(popular)
    print(f"\nrestarted service: restored {svc2.stats['spill_restored']} "
          f"spilled entries; popular repeats -> "
          f"{[x.status for x in r]} ({svc2.stats['hit']} served without "
          f"a single sweep)")
    shutil.rmtree(spill_dir)


if __name__ == "__main__":
    main()
