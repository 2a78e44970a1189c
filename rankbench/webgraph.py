"""The benchmark's crawls: a frozen copy of the port's matched generator
(``graph/generators.py::generate_webgraph``/``paper_dataset``) and of the
back-button transform (``core/backbutton.py::back_button``), over plain
numpy edge arrays.

The paper's crawls (Mirzal & Furukawa, arXiv:0909.0572, Table 7) are not
public, so a power-law graph matched to each crawl's pages, links and
share of dangling pages stands in. The copy is frozen here so that a
change to the program cannot change the benchmark's inputs.
It imports nothing of the program.

The port's generator draws a crawl's links and then drops repeats, which
leaves about half of Table 7's count; the copy here draws on until the
crawl has Table 7's count of distinct links. The port's links are all
kept, in the same draw, so it gives a superset of the port's edges at
the same seed.
"""
from __future__ import annotations

import zlib

import numpy as np

# name: (pages, links, pct_dangling, avg_degree)  (paper Table 7)
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


def dedup(n: int, src: np.ndarray, dst: np.ndarray):
    """Distinct edges, sorted by (src, dst)."""
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx].astype(np.int32), dst[idx].astype(np.int32)


def generate_webgraph(n: int, e: int, dangling_frac: float, seed: int,
                      alpha_in: float = 2.1, alpha_out: float = 2.7):
    """(src, dst) int32 edges of a directed power-law graph on ``n`` pages
    with ``e`` distinct links and a ``dangling_frac`` share of pages
    without out-links: the port's ``generate_webgraph``, whose ``e``
    links before dedup are topped up to ``e`` after it (``top_up``)."""
    rng = np.random.default_rng(seed)
    n_dangling = int(round(dangling_frac * n))
    n_src = max(n - n_dangling, 1)
    perm = rng.permutation(n)
    src_pool = perm[:n_src]
    w_out = rng.zipf(alpha_out, size=n_src).astype(np.float64)
    w_out = w_out / w_out.sum()
    outdeg = np.maximum(1, np.round(w_out * e)).astype(np.int64)
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
    ranks = rng.permutation(n) + 1
    w_in = ranks.astype(np.float64) ** (-(alpha_in - 1.0))
    w_in = w_in / w_in.sum()
    dst = rng.choice(n, size=src.shape[0], p=w_in).astype(np.int32)
    src, dst = dedup(n, src, dst)
    keep = src != dst
    return top_up(n, e, src[keep], dst[keep], src_pool, outdeg, w_in, rng)


def top_up(n: int, e: int, src: np.ndarray, dst: np.ndarray,
           src_pool: np.ndarray, outdeg: np.ndarray, w_in: np.ndarray,
           rng: np.random.Generator):
    """The port's distinct links plus more, drawn as the port draws them
    (a source with probability by its out-degree, a target by ``w_in``),
    until there are ``e`` distinct links without self-links. The port's
    dedup keeps about half of the links it draws (heavy sources draw the
    same targets again), where Table 7 counts distinct links. Sorted by
    (src, dst)."""
    if e > len(src_pool) * (n - 1):
        raise ValueError(f"{e} links do not fit {len(src_pool)} sources")
    pos = np.full(n, -1, np.int64)
    pos[src_pool] = np.arange(len(src_pool))
    seen = np.zeros(len(src_pool) * n, bool)  # (source's slot, target)
    seen[pos[src] * n + dst] = True
    p_src = outdeg / outdeg.sum()
    count = len(src)
    while count < e:
        need = e - count
        j = rng.choice(len(src_pool), size=2 * need, p=p_src)
        d = rng.choice(n, size=2 * need, p=w_in)
        k = j.astype(np.int64) * n + d
        k = k[(src_pool[j] != d) & ~seen[k]]
        _, first = np.unique(k, return_index=True)
        k = k[np.sort(first)][:need]
        seen[k] = True
        count += len(k)
    k = np.flatnonzero(seen)
    return dedup(n, src_pool[k // n], k % n)


def paper_dataset(name: str, seed: int, scale: float = 1.0,
                  alpha_in: float = 2.1, alpha_out: float = 2.7):
    """(n, src, dst) of the stand-in for Table 7's crawl ``name``; the
    generator's seed is ``seed`` plus the crc32 of the name, as the port's
    ``paper_dataset`` makes it."""
    pages, links, pct_dp, _avg = PAPER_TABLE7[name]
    n = max(int(pages * scale), 64)
    e = max(int(links * scale), 256)
    src, dst = generate_webgraph(
        n, e, pct_dp / 100.0, int(seed) + (zlib.crc32(name.encode()) % 65536),
        alpha_in, alpha_out)
    return n, src, dst


def back_button(n: int, src: np.ndarray, dst: np.ndarray):
    """The back-button graph L* = L + M of the paper's §3.3: for every link
    u -> v into a dangling page v, the link v -> u is added."""
    dangling = np.bincount(src, minlength=n) == 0
    into = dangling[dst]
    return dedup(n, np.concatenate([src, dst[into]]),
                 np.concatenate([dst, src[into]]))


def relabel(n: int, src: np.ndarray, dst: np.ndarray, seed: int,
            block: int = 128):
    """The same crawl under another page numbering drawn from ``seed``:
    the whole ``block``-page groups are shuffled among themselves and the
    pages inside each group, the last (short) group staying last. Every
    (block row, block column) pair that holds a link maps to one that
    does, so the blocks a blocked layout stores, and every sweep count,
    are the same for every seed: only their order changes."""
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    full = n // block
    bmap = np.arange(-(-n // block))
    bmap[:full] = rng.permutation(full)
    group = np.arange(n) // block
    order = np.lexsort((rng.random(n), group))
    new = np.empty(n, np.int64)
    new[order] = bmap[group] * block + np.arange(n) % block
    return dedup(n, new[src].astype(np.int32), new[dst].astype(np.int32))


def crawl(cfg: dict, seed: int, scale: float = 1.0):
    """(n, src, dst) of a configuration file's crawl, its pages numbered
    by ``seed``. The crawl itself is made at the configuration's own
    ``graph_seed``: the generator's seed changes the sweeps a ranking
    takes (7-10 on britannica-bb, 10-34 on yahoo-bb), so ``seed`` only
    renumbers the pages (``relabel``)."""
    n, src, dst = paper_dataset(cfg["crawl"], cfg["graph_seed"], scale,
                                cfg["alpha_in"], cfg["alpha_out"])
    if cfg["back_button"]:
        src, dst = back_button(n, src, dst)
    return (n, *relabel(n, src, dst, seed, cfg["block"]))
