"""Query-focused ranking service on the PyTorch port, end to end (the
reference's ``examples/query_ranking_service.py``, same sizes and lines),
on the card unless ``--device cpu``:

synthetic crawl -> RankService -> a mixed burst of queries batched as the
V columns of one accelerated-HITS traversal -> repeat/overlapping queries
served from cache or warm-started from converged scores.

    PYTHONPATH=src python examples/query_ranking_service_torch.py [--device cpu]
"""
import argparse
import time

import numpy as np

from repro_torch.core import accel_hits
from repro_torch.graph import paper_dataset
from repro_torch.serve import RankService, RankServiceConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    # britannica: the densest Table 7 set (avg degree ~47) — focused
    # subgraphs have real link structure to rank
    g = paper_dataset("britannica", scale=0.2)
    print(f"graph: N={g.n_nodes} E={g.n_edges} "
          f"dangling={g.dangling_fraction():.1%}")

    svc = RankService(g, RankServiceConfig(v_max=4, tol=1e-10, device=dev))
    rng = np.random.default_rng(7)
    queries = [rng.choice(g.n_nodes, size=4, replace=False)
               for _ in range(4)]

    # a cold burst: 4 queries, one traversal
    t0 = time.time()
    cold = svc.rank(queries)
    print(f"\ncold burst: 4 queries in {time.time() - t0:.2f}s")
    for r in cold:
        print(f"  roots={r.roots.tolist()} [{r.status}, {r.iters} sweeps, "
              f"{len(r.nodes)} focused pages] top-3 {r.topk(3)}")

    # the same burst again: pure cache hits, no iteration
    t0 = time.time()
    again = svc.rank(queries)
    print(f"\nrepeat burst: {sum(r.status == 'hit' for r in again)}/4 cache "
          f"hits in {time.time() - t0:.3f}s (identical scores: "
          f"{all(np.array_equal(a.authority, c.authority) for a, c in zip(again, cold))})")

    # refresh: warm-started from the cached vectors (paper §5)
    warm = svc.rank(queries, refresh=True)
    print("\nwarm refresh sweeps vs cold:",
          [(w.iters, c.iters) for w, c in zip(warm, cold)])

    # the service's batched column == the per-query oracle
    fs = svc.extractor.extract(queries[0])
    oracle = accel_hits(fs.graph, tol=1e-10, device=dev)
    l1 = float(np.abs(np.asarray(oracle.aux) - cold[0].authority).sum())
    print(f"\nbatched column vs per-query accel_hits oracle: L1={l1:.2e}")


if __name__ == "__main__":
    main()
