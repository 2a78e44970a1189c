"""Synthetic web-graph generators.

The paper's 8 crawled datasets (Table 7) are unavailable offline, so we
generate power-law directed graphs matched to the published statistics:
page count N, link count, dangling-page fraction %DP, and average degree.
In/out degree distributions follow the power laws reported for the web
graph (Broder et al. 2000: alpha_in ~ 2.1, alpha_out ~ 2.7), which is the
structural property the paper's acceleration exploits (skewed authority /
hub mass).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from .structure import Graph

# name: (pages, links, pct_dangling, avg_degree)  — paper Table 7
PAPER_TABLE7 = {
    "britannica":   (21104, 994554, 85.0, 47.1),
    "jobs":         (16056, 187957, 92.0, 11.7),
    "opera":        (49749, 437748, 95.4, 8.8),
    "python":       (57328, 449529, 93.5, 7.8),
    "scholarpedia": (74243, 1077781, 86.5, 14.5),
    "stanford":     (225441, 2196441, 96.7, 9.7),
    "wikipedia":    (10431, 46152, 96.1, 4.4),
    "yahoo":        (34054, 161700, 98.0, 4.7),
}


@dataclasses.dataclass(frozen=True)
class WebGraphSpec:
    n_nodes: int
    n_edges: int
    dangling_frac: float
    alpha_in: float = 2.1
    alpha_out: float = 2.7
    seed: int = 0


def _powerlaw_weights(n: int, alpha: float, rng: np.random.Generator) -> np.ndarray:
    """Unnormalized Zipf-like popularity weights over a random permutation."""
    ranks = rng.permutation(n) + 1
    return ranks.astype(np.float64) ** (-(alpha - 1.0))


def generate_webgraph(spec: WebGraphSpec) -> Graph:
    """Directed power-law graph with a controlled dangling fraction.

    Non-dangling sources get out-degrees from a power-law partition of the
    edge budget; destinations are sampled by preferential attachment over
    power-law popularity weights (dangling pages included — crawls produce
    many popular-but-unexplored pages, exactly the paper's %DP story).
    """
    rng = np.random.default_rng(spec.seed)
    n, e = spec.n_nodes, spec.n_edges
    n_dangling = int(round(spec.dangling_frac * n))
    n_src = max(n - n_dangling, 1)

    perm = rng.permutation(n)
    src_pool = perm[:n_src]           # non-dangling pages
    # out-degree split of the edge budget across sources (power law)
    w_out = rng.zipf(spec.alpha_out, size=n_src).astype(np.float64)
    w_out = w_out / w_out.sum()
    outdeg = np.maximum(1, np.round(w_out * e)).astype(np.int64)
    # trim/pad to hit the budget approximately
    excess = int(outdeg.sum() - e)
    if excess > 0:
        order = np.argsort(-outdeg)
        i = 0
        while excess > 0 and i < len(order):
            take = min(excess, int(outdeg[order[i]]) - 1)
            outdeg[order[i]] -= take
            excess -= take
            i += 1
    src = np.repeat(src_pool, outdeg).astype(np.int32)

    # destination popularity: power-law over all pages
    w_in = _powerlaw_weights(n, spec.alpha_in, rng)
    w_in = w_in / w_in.sum()
    dst = rng.choice(n, size=src.shape[0], p=w_in).astype(np.int32)

    g = Graph(n, src, dst).dedup()
    # remove self loops
    keep = g.src != g.dst
    g = Graph(n, g.src[keep], g.dst[keep])
    # restore exact danglingness (dedup cannot create out-edges for dangling)
    return g


def paper_dataset(name: str, scale: float = 1.0, seed: int = 0) -> Graph:
    """Synthetic stand-in for a paper Table 7 dataset. ``scale`` shrinks N and
    E proportionally (tests use scale<1; benchmarks use 1.0)."""
    pages, links, pct_dp, _ad = PAPER_TABLE7[name]
    spec = WebGraphSpec(
        n_nodes=max(int(pages * scale), 64),
        n_edges=max(int(links * scale), 256),
        dangling_frac=pct_dp / 100.0,
        # crc32, NOT hash(): str hash is salted per process (PYTHONHASHSEED),
        # which made every dataset — and the tests on it — nondeterministic.
        seed=seed + (zlib.crc32(name.encode()) % 65536),
    )
    return generate_webgraph(spec)


def all_paper_datasets(scale: float = 1.0, seed: int = 0):
    return {name: paper_dataset(name, scale, seed) for name in PAPER_TABLE7}


def bipartite_interactions(n_users: int, n_items: int, n_edges: int,
                           alpha_item: float = 2.0, seed: int = 0) -> Graph:
    """User->item interaction graph (for retrieval-with-HITS). Users occupy
    ids [0, n_users), items [n_users, n_users + n_items)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_users, size=n_edges).astype(np.int32)
    w = _powerlaw_weights(n_items, alpha_item, rng)
    w = w / w.sum()
    dst = (n_users + rng.choice(n_items, size=n_edges, p=w)).astype(np.int32)
    return Graph(n_users + n_items, src, dst).dedup()
