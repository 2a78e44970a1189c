"""The paper's technique as a first-class retrieval feature, on the
PyTorch port: accelerated HITS over the user->item interaction graph
yields an item-authority prior blended into two-tower candidate scoring
(the reference's ``examples/retrieval_with_hits.py``, same sizes and
lines), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/retrieval_with_hits_torch.py [--device cpu]

The HITS lines equal the reference's (the same graph, f64); the trained
loss differs from the reference's, whose init and batches come from
``jax.random``.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import accel_hits
from repro_torch.graph import bipartite_interactions
from repro_torch.models.recsys import (TwoTowerConfig, init_twotower_params,
                                       retrieval_topk, twotower_loss)
from repro_torch.train import (AdamWConfig, DataConfig, init_opt_state,
                               make_train_step, to_device, twotower_batch)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = torch.device(ap.parse_args().device)

    n_users, n_items = 2000, 3000
    g = bipartite_interactions(n_users, n_items, 30000, seed=7)
    print(f"interaction graph: {n_users} users, {n_items} items, "
          f"{g.n_edges} interactions")

    # 1) item authority via the paper's accelerated HITS (items = dsts)
    r = accel_hits(g, tol=1e-9, device=dev)
    prior = torch.from_numpy(np.asarray(r.aux[n_users:]) + 1e-12).to(dev)
    print(f"accelerated HITS: {r.iters} iters; "
          f"top item authority={float(prior.max()):.5f}")

    # 2) train the two-tower retriever briefly
    cfg = TwoTowerConfig(name="tt", embed_dim=32, tower_mlp=(64, 32),
                         n_users=n_users, n_items=n_items)
    params = init_twotower_params(cfg, seed=0, device=dev)
    dc = DataConfig(kind="twotower", global_batch=256, seed=1)
    step = make_train_step(
        lambda p, b: twotower_loss(p, b, cfg),
        AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=60))
    st = init_opt_state(params)
    for s in range(60):
        params, st, m = step(params, st, to_device(
            twotower_batch(dc, s, n_users, n_items), dev))
    print(f"two-tower trained: loss={float(m['loss']):.3f}")

    # 3) retrieval with and without the authority prior
    users = torch.arange(8, device=dev)
    cands = torch.arange(n_items, device=dev)
    with torch.no_grad():
        _, base = retrieval_topk(params, users, cands, k=20)
        _, blended = retrieval_topk(params, users, cands, k=20,
                                    prior=prior, prior_weight=0.5)
    pri = prior.cpu().numpy()
    print(f"mean authority of top-20: base={pri[base.cpu().numpy()].mean():.2e} "
          f"blended={pri[blended.cpu().numpy()].mean():.2e} "
          f"(prior promotes popular items)")


if __name__ == "__main__":
    main()
