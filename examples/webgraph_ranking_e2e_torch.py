"""End-to-end production ranking job (the paper's workload as deployed):

crawl-scale synthetic web graph -> back-button transform -> fault-tolerant
sharded engine (checkpointing + simulated stragglers) -> accelerated-HITS
vectors -> exact QI-HITS refinement warm-started from them (paper §5) ->
ranked index written to disk. The PyTorch port of the reference's
``examples/webgraph_ranking_e2e.py`` (same sizes and lines), on the card
unless ``--device cpu``.

    PYTHONPATH=src python examples/webgraph_ranking_e2e_torch.py [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import back_button, qi_hits, spearman
from repro_torch.core.engine import RankingEngine
from repro_torch.core.hits import EdgeList, hits_sweep
from repro_torch.core.power import power_method
from repro_torch.graph import paper_dataset


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    g = back_button(paper_dataset("stanford", scale=0.15))
    print(f"graph: N={g.n_nodes} E={g.n_edges} "
          f"dangling={g.dangling_fraction():.1%}")

    ckpt = tempfile.mkdtemp(prefix="rank_ckpt_")
    eng = RankingEngine(g, "accel", n_shards=8, stale_limit=2,
                        straggler_prob=0.15, checkpoint_dir=ckpt,
                        checkpoint_every=10, seed=0, device=dev)
    t0 = time.time()
    res = eng.run(tol=1e-9)
    print(f"accelerated HITS: {res.iters} iters, {time.time()-t0:.1f}s, "
          f"stale_events={res.stale_events} (bounded-staleness tolerated), "
          f"checkpoints in {ckpt}")

    # paper §5: a few QI-HITS sweeps warm-started from the accelerated
    # vectors recover the exact fixed point cheaply
    t0 = time.time()
    warm = power_method(hits_sweep(EdgeList.from_graph(g, dev)),
                        torch.from_numpy(res.hub).to(dev), tol=1e-9)
    cold = qi_hits(g, tol=1e-9, device=dev)
    print(f"QI-HITS refinement: {warm.iters} warm-start iters vs "
          f"{cold.iters} from cold ({time.time()-t0:.1f}s)")
    print(f"final agreement with exact QI-HITS: "
          f"spearman={spearman(warm.v, cold.v):.4f}")

    out = os.path.join(ckpt, "ranked_index.npz")
    order = np.argsort(-res.authority)
    np.savez(out, page=order, authority=res.authority[order])
    print(f"ranked index written: {out} ({len(order)} pages)")


if __name__ == "__main__":
    main()
