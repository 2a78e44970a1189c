"""Deterministic synthetic data pipeline (port of ``repro.train.data``).

Every batch is a pure function of (seed, step): one CPU
``torch.Generator`` seeded from the pair draws it, so any worker can
regenerate any shard of any step (the property elastic restart relies
on: after a world-size change the new shard assignment replays identical
global batches), and a card run and a host run see the same batch. The
distributions are the reference's; the bits are not ``jax.random``'s, so
tests that compare the packages feed the reference's batches to both.
The caller moves a batch to its device (``to_device``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..tree import tree_map


@dataclasses.dataclass(frozen=True)
class DataConfig:
    kind: str                  # "lm" | "recsys" | "bst" | "twotower" | "gnn"
    global_batch: int
    seq_len: int = 0
    vocab: int = 0
    n_dense: int = 13
    n_sparse: int = 26
    sparse_vocab: int = 1000
    seed: int = 0


def _gen(cfg: DataConfig, step: int) -> torch.Generator:
    """The generator of (cfg.seed, step): ``jax.random.fold_in``'s role."""
    state = np.random.SeedSequence([int(cfg.seed), int(step)]) \
        .generate_state(1, np.uint64)[0]
    g = torch.Generator()
    g.manual_seed(int(state))
    return g


def lm_batch(cfg: DataConfig, step: int):
    """Synthetic Zipf-ish token stream with a learnable bigram structure so
    a real model actually reduces loss on it: tokens drawn with
    p(t) ∝ 1/(t + 10), and every token at an even position repeats the
    one before it (position 0 takes the row's last draw, ``jnp.roll``)."""
    g = _gen(cfg, step)
    b, s = cfg.global_batch, cfg.seq_len
    p = 1.0 / (torch.arange(cfg.vocab, dtype=torch.float64) + 10.0)
    base = torch.multinomial(p, b * (s + 1), replacement=True,
                             generator=g).reshape(b, s + 1)
    pos = torch.arange(s + 1)
    shifted = torch.roll(base, 1, dims=1)
    toks = torch.where((pos % 2 == 0)[None, :], shifted, base)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def recsys_batch(cfg: DataConfig, step: int):
    g = _gen(cfg, step)
    b = cfg.global_batch
    dense = torch.randn((b, cfg.n_dense), generator=g)
    sparse = torch.randint(0, cfg.sparse_vocab, (b, cfg.n_sparse),
                           generator=g)
    # label correlated with a dense feature so training can learn
    noise = torch.randn((b,), generator=g)
    label = (dense[:, 0] + 0.1 * noise > 0).float()
    return {"dense": dense, "sparse": sparse, "label": label}


def bst_batch(cfg: DataConfig, step: int, seq_len: int = 20):
    g = _gen(cfg, step)
    b = cfg.global_batch
    hist = torch.randint(0, cfg.sparse_vocab, (b, seq_len), generator=g)
    target = torch.randint(0, cfg.sparse_vocab, (b,), generator=g)
    label = (torch.rand((b,), generator=g) > 0.5).float()
    return {"hist": hist, "target": target, "label": label}


def twotower_batch(cfg: DataConfig, step: int, n_users: int, n_items: int):
    g = _gen(cfg, step)
    b = cfg.global_batch
    user = torch.randint(0, n_users, (b,), generator=g)
    # correlated positives: item id tied to user id (learnable retrieval)
    item = (user * 7 + torch.randint(0, 3, (b,), generator=g)) % n_items
    return {"user": user, "item": item}


def shard_of_batch(batch, shard_id: int, n_shards: int):
    """Deterministic shard slice (for elastic-restart tests)."""
    def sl(x):
        per = x.shape[0] // n_shards
        return x[shard_id * per:(shard_id + 1) * per]
    return tree_map(sl, batch)


def to_device(batch, device):
    """Every leaf of ``batch`` as a tensor on ``device`` (numpy arrays, e.g.
    the reference's batches, included)."""
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)
                                              if not torch.is_tensor(x)
                                              else x).to(device), batch)
