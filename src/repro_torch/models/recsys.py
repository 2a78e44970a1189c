"""RecSys architectures: two-tower retrieval, DLRM, DCN-v2, BST (port of
``repro.models.recsys``).

Each architecture is an ``nn.Module`` whose parameters sit at the
reference's tree paths (``table``, ``bot.w.0``, ``blocks.wq``,
``user_tower.b.2``, ...): ``p["bot"]["w"][0]`` indexes a module as the
reference indexes its parameter dict, so the functions below read like
the reference's. ``to_tree()`` gives the reference's nested dict/tuple
of the same tensors (what the optimizer and a checkpoint walk) and
``params_from_reference`` copies a tree of arrays (e.g. the JAX
package's parameters) into the module.

Lookups are ``F.embedding`` over one unified table (all field vocabs
concatenated, per-field offsets), the FBGEMM/TBE layout of the
reference. On the card its backward sums the rows of repeated ids by a
sort, without float atomics (``index_select``'s backward is an
``index_add_`` with atomics), so two runs of a step give the same bits;
``embedding_bag`` sums its bags by a stable sort and
``torch.segment_reduce``, as ``sparse.spmv`` does.

Init draws from a seeded ``torch.Generator`` on the module's device with
the reference's scales (``1/sqrt(fan_in)`` normal MLP weights, zero
biases, 0.01 tables, BST's ``0.5*s`` on ``ff2``); ``jax.random``'s bits
cannot be reproduced, so tests carry the reference's parameters across.

Bipartite user→item interaction graphs feed the accelerated-HITS
authority prior (examples/retrieval_with_hits_torch.py): the paper's
technique as a retrieval feature.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import resolve_device
from .layers import chunked_attention, dense_mlp
from .params import Group, ParamTree
from .params import generator as _gen
from .params import normal as _normal
from .sharding import DP, P, shard_hint


# ------------------------------------------------------------ the modules
class MLP(ParamTree):
    """``{"w": (...), "b": (...)}``."""

    def __init__(self, ws, bs):
        super().__init__()
        self.w = nn.ParameterList([nn.Parameter(x) for x in ws])
        self.b = nn.ParameterList([nn.Parameter(x) for x in bs])


def _mlp_params(gen, dims, device) -> MLP:
    ws, bs = [], []
    for i in range(len(dims) - 1):
        s = float(1.0 / np.sqrt(dims[i]))
        ws.append(_normal(gen, (dims[i], dims[i + 1]), s, device))
        bs.append(torch.zeros((dims[i + 1],), dtype=torch.float32,
                              device=device))
    return MLP(ws, bs)


def _mlp_apply(p, x, act=F.relu, final_act=False):
    return dense_mlp(x, p["w"], p["b"], act=act, final_act=final_act)


class RecsysModel(Group):
    """A recsys architecture: its config, its parameters, its loss."""

    cfg = None

    def loss(self, batch):
        raise NotImplementedError


# --------------------------------------------------------------- EmbeddingBag
def unified_table_offsets(vocab_sizes) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)


def _ids(x, device):
    return torch.as_tensor(x).to(device=device, dtype=torch.long)


def embedding_lookup(table, ids, offsets):
    """Single-hot per-field lookup. ids: (B, F) field-local; returns
    (B, F, dim)."""
    ids = _ids(ids, table.device)
    flat = ids + _ids(offsets, table.device)[None, :]
    return F.embedding(flat, table)


def embedding_bag(table, flat_ids, segment_ids, n_segments: int,
                  combiner: str = "sum", weights=None):
    """Multi-hot bag reduce: rows gathered by flat_ids, summed per segment
    (nn.EmbeddingBag parity). The rows are taken in a stable sort by
    segment, so each bag adds its rows in input order, without atomics."""
    seg = _ids(segment_ids, table.device)
    order = torch.argsort(seg, stable=True)
    rows = F.embedding(_ids(flat_ids, table.device)[order], table)
    if weights is not None:
        w = torch.as_tensor(weights).to(table.device)[order]
        rows = rows * w[:, None]
    lengths = torch.bincount(seg, minlength=n_segments)
    out = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0)
    if combiner == "mean":
        cnt = lengths.to(out.dtype)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


# --------------------------------------------------------------------- DLRM
@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    vocab_per_field: int = 1_000_000
    bot_mlp: Tuple[int, ...] = (13, 512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)

    @property
    def vocab_sizes(self):
        return [self.vocab_per_field] * self.n_sparse

    @property
    def n_interactions(self):
        f = self.n_sparse + 1
        return f * (f - 1) // 2


class DLRM(RecsysModel):
    def __init__(self, cfg: DLRMConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        g = _gen(seed, dev)
        top_in = cfg.n_interactions + cfg.embed_dim
        super().__init__(
            table=_normal(g, (sum(cfg.vocab_sizes), cfg.embed_dim), 0.01,
                          dev),
            bot=_mlp_params(g, cfg.bot_mlp, dev),
            top=_mlp_params(g, (top_in,) + cfg.top_mlp, dev))
        self.cfg = cfg
        self.offsets = unified_table_offsets(cfg.vocab_sizes)

    def forward(self, dense, sparse_ids):
        return dlrm_logits(self, dense, sparse_ids, self.cfg, self.offsets)

    def loss(self, batch):
        return dlrm_loss(self, batch, self.cfg, self.offsets)


def dlrm_specs(cfg: DLRMConfig):
    return {
        "table": P("model", None),
        "bot": {"w": tuple(P(None, None) for _ in range(len(cfg.bot_mlp) - 1)),
                "b": tuple(P(None) for _ in range(len(cfg.bot_mlp) - 1))},
        "top": {"w": tuple(P(None, None) for _ in range(len(cfg.top_mlp))),
                "b": tuple(P(None) for _ in range(len(cfg.top_mlp)))},
    }


def dlrm_logits(params, dense, sparse_ids, cfg: DLRMConfig, offsets):
    d = _mlp_apply(params["bot"], dense, final_act=True)      # (B, dim)
    e = embedding_lookup(params["table"], sparse_ids, offsets)  # (B, F, dim)
    e = shard_hint(e, DP, None, None)
    z = torch.cat([d[:, None, :], e], dim=1)                  # (B, F+1, dim)
    inter = torch.bmm(z, z.transpose(1, 2))                   # (B, F+1, F+1)
    f = z.shape[1]
    iu, ju = torch.triu_indices(f, f, offset=1, device=z.device)  # row-major
    pairs = inter[:, iu, ju]                                  # (B, F(F-1)/2)
    top_in = torch.cat([pairs, d], dim=1)
    return _mlp_apply(params["top"], top_in)[:, 0]


# -------------------------------------------------------------------- DCN-v2
@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str = "dcn-v2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    vocab_per_field: int = 1_000_000
    n_cross_layers: int = 3
    deep_mlp: Tuple[int, ...] = (1024, 1024, 512)

    @property
    def vocab_sizes(self):
        return [self.vocab_per_field] * self.n_sparse

    @property
    def d_input(self):
        return self.n_dense + self.n_sparse * self.embed_dim


class DCN(RecsysModel):
    def __init__(self, cfg: DCNConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        g = _gen(seed, dev)
        d0 = cfg.d_input
        s = float(1.0 / np.sqrt(d0))
        super().__init__(
            table=_normal(g, (sum(cfg.vocab_sizes), cfg.embed_dim), 0.01,
                          dev),
            cross_w=_normal(g, (cfg.n_cross_layers, d0, d0), s, dev),
            cross_b=torch.zeros((cfg.n_cross_layers, d0),
                                dtype=torch.float32, device=dev),
            deep=_mlp_params(g, (d0,) + cfg.deep_mlp, dev),
            final=_mlp_params(g, (d0 + cfg.deep_mlp[-1], 1), dev))
        self.cfg = cfg
        self.offsets = unified_table_offsets(cfg.vocab_sizes)

    def forward(self, dense, sparse_ids):
        return dcn_logits(self, dense, sparse_ids, self.cfg, self.offsets)

    def loss(self, batch):
        return dcn_loss(self, batch, self.cfg, self.offsets)


def dcn_specs(cfg: DCNConfig):
    return {
        "table": P("model", None),
        "cross_w": P(None, None, "model"),
        "cross_b": P(None, None),
        "deep": {"w": (P(None, "model"), P("model", None), P(None, None)),
                 "b": (P("model"), P(None), P(None))},
        "final": {"w": (P(None, None),), "b": (P(None),)},
    }


def dcn_logits(params, dense, sparse_ids, cfg: DCNConfig, offsets):
    e = embedding_lookup(params["table"], sparse_ids, offsets)
    x0 = torch.cat([dense, e.reshape(e.shape[0], -1)], dim=1)   # (B, d0)
    x0 = shard_hint(x0, DP, None)
    x = x0
    for w, b in zip(params["cross_w"], params["cross_b"]):     # lax.scan
        x = x0 * (x @ w + b) + x
    x_deep = _mlp_apply(params["deep"], x0, final_act=True)
    out = torch.cat([x, x_deep], dim=1)
    return _mlp_apply(params["final"], out)[:, 0]


# ----------------------------------------------------------------------- BST
@dataclasses.dataclass(frozen=True)
class BSTConfig:
    name: str = "bst"
    embed_dim: int = 32
    seq_len: int = 20
    n_blocks: int = 1
    n_heads: int = 8
    vocab: int = 1_000_000
    mlp: Tuple[int, ...] = (1024, 512, 256)

    @property
    def d_head(self):
        return self.embed_dim // self.n_heads


class BST(RecsysModel):
    def __init__(self, cfg: BSTConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        g = _gen(seed, dev)
        d, nb = cfg.embed_dim, cfg.n_blocks
        s = float(1.0 / np.sqrt(d))
        seq_total = cfg.seq_len + 1  # history + target item
        super().__init__(
            table=_normal(g, (cfg.vocab, d), 0.01, dev),
            pos=_normal(g, (seq_total, d), 0.01, dev),
            blocks=Group(
                wq=_normal(g, (nb, d, d), s, dev),
                wk=_normal(g, (nb, d, d), s, dev),
                wv=_normal(g, (nb, d, d), s, dev),
                wo=_normal(g, (nb, d, d), s, dev),
                ff1=_normal(g, (nb, d, 4 * d), s, dev),
                ff2=_normal(g, (nb, 4 * d, d), 0.5 * s, dev)),
            mlp=_mlp_params(g, (seq_total * d,) + cfg.mlp + (1,), dev))
        self.cfg = cfg

    def forward(self, hist_ids, target_id):
        return bst_logits(self, hist_ids, target_id, self.cfg)

    def loss(self, batch):
        return bst_loss(self, batch, self.cfg)


def bst_specs(cfg: BSTConfig):
    return {
        "table": P("model", None),
        "pos": P(None, None),
        "blocks": {k: P(None, None, None) for k in
                   ("wq", "wk", "wv", "wo", "ff1", "ff2")},
        "mlp": {"w": (P(None, "model"), P("model", None), P(None, None),
                      P(None, None)),
                "b": (P("model"), P(None), P(None), P(None))},
    }


def bst_logits(params, hist_ids, target_id, cfg: BSTConfig):
    """hist_ids: (B, seq_len); target_id: (B,)."""
    table = params["table"]
    ids = torch.cat([_ids(hist_ids, table.device),
                     _ids(target_id, table.device)[:, None]], dim=1)
    x = shard_hint(F.embedding(ids, table) + params["pos"][None],
                   DP, None, None)
    b, s, d = x.shape
    h, dh = cfg.n_heads, cfg.d_head
    bp = params["blocks"]
    for i in range(bp["wq"].shape[0]):                         # lax.scan
        q = (x @ bp["wq"][i]).reshape(b, s, h, dh)
        k = (x @ bp["wk"][i]).reshape(b, s, h, dh)
        v = (x @ bp["wv"][i]).reshape(b, s, h, dh)
        att = chunked_attention(q, k, v, causal=False, chunk=max(s, 8))
        x = x + att.reshape(b, s, d) @ bp["wo"][i]
        x = x + F.leaky_relu(x @ bp["ff1"][i], 0.01) @ bp["ff2"][i]
    return _mlp_apply(params["mlp"], x.reshape(b, -1),
                      act=lambda t: F.leaky_relu(t, 0.01))[:, 0]


# ----------------------------------------------------------------- two-tower
@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    n_users: int = 1_000_000
    n_items: int = 1_000_000
    temperature: float = 0.05


class TwoTower(RecsysModel):
    def __init__(self, cfg: TwoTowerConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        g = _gen(seed, dev)
        d = cfg.embed_dim
        super().__init__(
            user_table=_normal(g, (cfg.n_users, d), 0.01, dev),
            item_table=_normal(g, (cfg.n_items, d), 0.01, dev),
            user_tower=_mlp_params(g, (d,) + cfg.tower_mlp, dev),
            item_tower=_mlp_params(g, (d,) + cfg.tower_mlp, dev))
        self.cfg = cfg

    def loss(self, batch):
        return twotower_loss(self, batch, self.cfg)


def twotower_specs(cfg: TwoTowerConfig):
    t3 = {"w": (P(None, "model"), P("model", None), P(None, None)),
          "b": (P("model"), P(None), P(None))}
    return {
        "user_table": P("model", None),
        "item_table": P("model", None),
        "user_tower": t3,
        "item_tower": t3,
    }


def init_twotower_params(cfg: TwoTowerConfig, seed: int = 0,
                         device="cuda") -> TwoTower:
    """The reference's name, kept for the retrieval example; ``build``
    makes the module of any recsys config."""
    return TwoTower(cfg, seed, device)


def _l2norm(x):
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=1e-6)


def user_embed(params, user_ids):
    t = params["user_table"]
    return _l2norm(_mlp_apply(params["user_tower"],
                              F.embedding(_ids(user_ids, t.device), t)))


def item_embed(params, item_ids):
    t = params["item_table"]
    return _l2norm(_mlp_apply(params["item_tower"],
                              F.embedding(_ids(item_ids, t.device), t)))


def twotower_inbatch_loss(params, user_ids, item_ids, cfg: TwoTowerConfig):
    """In-batch sampled softmax (positives on the diagonal)."""
    u = user_embed(params, user_ids)
    # every device scores its users against the whole batch's items: XLA
    # moves the items' rows onto the model axis (a collective-permute) and
    # gathers them there, so that the logits' backward products split
    # along those model shards
    v = shard_hint(item_embed(params, item_ids), "model", None)
    v = shard_hint(v, None, None)
    logits = (u @ v.T) / cfg.temperature                      # (B, B)
    logits = shard_hint(logits, DP, None)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.diagonal().mean()


def retrieval_scores(params, user_ids, cand_ids, prior=None,
                     prior_weight: float = 0.0):
    """Score users against a large candidate set (batched dot, no loop).

    prior: optional per-candidate authority prior (accelerated-HITS
    output) blended into the score — the paper's technique in the serving
    path. A float64 prior makes the scores float64, as it does in the
    reference (x64 on)."""
    u = user_embed(params, user_ids)                          # (B, d)
    v = item_embed(params, cand_ids)                          # (C, d)
    v = shard_hint(v, DP, None)
    scores = u @ v.T                                          # (B, C)
    if prior is not None:
        prior = torch.as_tensor(prior).to(scores.device)
        scores = scores + prior_weight * torch.log(prior + 1e-12)[None, :]
    return scores


def topk(scores, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the
    lowest index (a stable descending sort; ``torch.topk`` does not order
    ties). Where a gradient flows (the MoE router), the values are
    gathered at the sorted indices, the same numbers, so their gradient
    is ``gather``'s on every torch version: a sort's backward makes its
    zeros one way on torch 2.11 and another on 2.13, which the dry-run
    would count apart."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return (scores.gather(-1, idx) if scores.requires_grad
            else vals[..., :k]), idx


def retrieval_topk(params, user_ids, cand_ids, k: int = 100, prior=None,
                   prior_weight: float = 0.0):
    scores = retrieval_scores(params, user_ids, cand_ids, prior,
                              prior_weight)
    return topk(scores, k)


# --------------------------------------------------------------- BCE losses
def bce_loss(logits, labels):
    logits = logits.float()
    return torch.mean(torch.clamp(logits, min=0) - logits * labels +
                      torch.log1p(torch.exp(-logits.abs())))


def dlrm_loss(params, batch, cfg: DLRMConfig, offsets):
    return bce_loss(dlrm_logits(params, batch["dense"], batch["sparse"],
                                cfg, offsets), batch["label"])


def dcn_loss(params, batch, cfg: DCNConfig, offsets):
    return bce_loss(dcn_logits(params, batch["dense"], batch["sparse"],
                               cfg, offsets), batch["label"])


def bst_loss(params, batch, cfg: BSTConfig):
    return bce_loss(bst_logits(params, batch["hist"], batch["target"], cfg),
                    batch["label"])


def twotower_loss(params, batch, cfg: TwoTowerConfig):
    return twotower_inbatch_loss(params, batch["user"], batch["item"], cfg)


MODELS = {DLRMConfig: DLRM, DCNConfig: DCN, BSTConfig: BST,
          TwoTowerConfig: TwoTower}


def build(cfg, seed: int = 0, device="cuda") -> RecsysModel:
    """The module of ``cfg``'s architecture, initialised from ``seed``."""
    return MODELS[type(cfg)](cfg, seed, device)
