"""Quickstart on the PyTorch port: accelerated HITS vs QI-HITS vs PageRank
on a synthetic crawl (the reference's ``examples/quickstart.py``, same
sizes and lines), on the card unless ``--device cpu``.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.core import (accel_hits, back_button, cosine, pagerank,
                              qi_hits, spearman, topk)
from repro_torch.graph import paper_dataset


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = ap.parse_args().device

    g = paper_dataset("wikipedia", scale=0.3)
    print(f"synthetic 'wikipedia' crawl: {g.n_nodes} pages, {g.n_edges} links,"
          f" {g.dangling_fraction():.0%} dangling")

    print("\n-- original dataset (paper Fig. 2) --")
    rh = qi_hits(g, tol=1e-9, device=dev)
    ra = accel_hits(g, tol=1e-9, device=dev)
    rp = pagerank(g, tol=1e-9, device=dev)
    print(f"QI-HITS   : {rh.iters:4d} iterations")
    print(f"Prop. Alg : {ra.iters:4d} iterations   <- the paper's method")
    print(f"PageRank  : {rp.iters:4d} iterations")
    print(f"agreement with QI-HITS: cosine={cosine(ra.aux, rh.aux):.3f} "
          f"spearman={spearman(ra.aux, rh.aux):.3f}")

    print("\n-- back-button model (paper Fig. 3) --")
    bb = back_button(g)
    print(f"L* = L + M: {bb.n_edges} links, {bb.dangling_fraction():.0%} dangling")
    rh2 = qi_hits(bb, tol=1e-9, device=dev)
    ra2 = accel_hits(bb, tol=1e-9, device=dev)
    rp2 = pagerank(bb, tol=1e-9, device=dev)
    print(f"QI-HITS   : {rh2.iters:4d} iterations")
    print(f"Prop. Alg : {ra2.iters:4d} iterations   <- fastest, as the paper claims")
    print(f"PageRank  : {rp2.iters:4d} iterations")

    print("\n-- top-5 authorities (accelerated) --")
    for i in topk(ra2.aux, 5):
        print(f"  page {int(i):6d}  authority={ra2.aux[i]:.5f} "
              f"indeg={int(np.asarray(bb.indeg())[i])}")


if __name__ == "__main__":
    main()
