"""Production ranking launcher — the paper's workload as a job (port of
``repro.launch.rank``, on the card unless ``--device cpu``).

Runs accelerated-HITS (or QI-HITS) over a (synthetic or saved) web graph
with the fault-tolerant engine: sharding, checkpoint/restart, straggler
tolerance. Every flag is the reference's, plus ``--device``; a checkpoint
directory written by either package resumes in the other.

  PYTHONPATH=src python -m repro_torch.launch.rank --dataset wikipedia \
      --scale 0.5 --algorithm accel --backbutton --ckpt /tmp/rank_ckpt
  PYTHONPATH=src python -m repro_torch.launch.rank --device cpu \
      --dataset wikipedia --scale 0.1
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="wikipedia",
                    help="paper dataset name or 'synthetic'")
    ap.add_argument("--scale", type=float, default=0.25)
    ap.add_argument("--n-nodes", type=int, default=50000)
    ap.add_argument("--n-edges", type=int, default=400000)
    ap.add_argument("--dangling", type=float, default=0.9)
    ap.add_argument("--algorithm", default="accel", choices=["accel", "hits"])
    ap.add_argument("--backbutton", action="store_true")
    ap.add_argument("--tol", type=float, default=1e-9)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--stale-limit", type=int, default=0)
    ap.add_argument("--straggler-prob", type=float, default=0.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--topk", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine's vectors (cuda, cpu)")
    args = ap.parse_args()

    from ..core import back_button
    from ..core.engine import RankingEngine
    from ..graph import WebGraphSpec, generate_webgraph, paper_dataset

    if args.dataset == "synthetic":
        g = generate_webgraph(WebGraphSpec(args.n_nodes, args.n_edges,
                                           args.dangling))
    else:
        g = paper_dataset(args.dataset, scale=args.scale)
    print(f"graph: N={g.n_nodes} E={g.n_edges} "
          f"dangling={g.dangling_fraction():.1%}")
    if args.backbutton:
        g = back_button(g)
        print(f"back-button: E={g.n_edges} dangling={g.dangling_fraction():.1%}")

    eng = RankingEngine(g, args.algorithm, n_shards=args.shards,
                        stale_limit=args.stale_limit,
                        straggler_prob=args.straggler_prob,
                        checkpoint_dir=args.ckpt,
                        checkpoint_every=args.ckpt_every,
                        device=args.device)
    t0 = time.time()
    res = eng.run(tol=args.tol, resume=args.resume)
    dt = time.time() - t0
    print(f"{args.algorithm}: converged={res.converged} iters={res.iters} "
          f"residual={res.residuals[-1]:.2e} wall={dt:.2f}s "
          f"stale_events={res.stale_events}")
    top = np.argsort(-res.authority)[: args.topk]
    print("top authorities:", json.dumps(
        [{"page": int(i), "score": float(res.authority[i])} for i in top]))


if __name__ == "__main__":
    main()
