"""GIN (Xu et al., ICLR'19) message passing (port of ``repro.models.gnn``).

Three execution modes matching the assigned shapes:
* full-graph   (full_graph_sm / ogb_products): all nodes + edges at once
* sampled      (minibatch_lg): fanout-sampled k-hop blocks from
  graph.sampler
* batched      (molecule): padded per-graph tensors, flattened into one
  edge set (graph g's nodes at rows g·n..g·n + n - 1), which takes the
  place of the reference's ``jax.vmap``

The ``segment`` aggregation (the reference's ``jax.ops.segment_sum`` of
gathered messages) is ``kernels.ops.aggregate``: the messages are
gathered straight into K3's tiled layout and summed by K3, forward and
backward, with no float atomics (two identical steps give the same bits)
and no host reads. The layouts are built once per edge set by whoever
makes the edges (``sample_khop``, the trainer) and passed on as
``lay=``, or in a batch under ``"lay"``; an entry point given none uses
``EdgeLayouts.of``, cached by the identity of the edge tensors. K3
sums each tile's row in f64 and rounds once, where XLA adds edge by
edge in f32, so the two differ by a few ulps. ``onehot`` is the
reference's one-hot product, here ``torch.einsum``; its gathers are
one-hot products too (exact in the forward, no atomics in the
backward).

``GIN``'s parameters sit at the reference's tree paths (``encoder``,
``layers/{eps, w1, b1, w2, b2}`` stacked over the L layers,
``classifier``); init draws from a seeded ``torch.Generator`` with the
reference's scales, so tests carry the reference's parameters across
(``params_from_reference``). Losses are the reference's f32
log-softmax cross-entropies.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.ops import EdgeLayouts, aggregate
from ..runtime import resolve_device, torch_dtype
from .params import Group
from .params import generator as _gen
from .params import normal as _normal
from .sharding import DP, shard_hint


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_in: int = 64
    d_hidden: int = 64
    n_classes: int = 16
    task: str = "node"          # "node" | "graph"
    param_dtype: str = "float32"
    agg: str = "segment"        # "segment" (K3) | "onehot" (einsum)

    def pdt(self):
        return torch_dtype(self.param_dtype)


class GIN(Group):
    """GIN's parameters as a module (the reference's ``init_gin_params``
    tree): ``encoder`` (d_in, dh), ``layers`` {eps (L,), w1, w2 (L, dh,
    dh), b1, b2 (L, dh)}, ``classifier`` (dh, n_classes)."""

    def __init__(self, cfg: GINConfig, seed: int = 0, device="cuda"):
        dev = resolve_device(device)
        g = _gen(seed, dev)
        pdt = cfg.pdt()
        L, dh = cfg.n_layers, cfg.d_hidden
        s_in, s_h = float(1.0 / np.sqrt(cfg.d_in)), float(1.0 / np.sqrt(dh))

        def zeros(*shape):
            return torch.zeros(shape, dtype=pdt, device=dev)

        super().__init__(
            encoder=_normal(g, (cfg.d_in, dh), s_in, dev, pdt),
            layers={"eps": zeros(L),
                    "w1": _normal(g, (L, dh, dh), s_h, dev, pdt),
                    "b1": zeros(L, dh),
                    "w2": _normal(g, (L, dh, dh), s_h, dev, pdt),
                    "b2": zeros(L, dh)},
            classifier=_normal(g, (dh, cfg.n_classes), s_h, dev, pdt))
        self.cfg = cfg


def _layer(params, i: int) -> dict:
    """Layer i's slice of the stacked ``layers`` parameters."""
    lp = params["layers"]
    return {k: lp[k][i] for k in ("eps", "w1", "b1", "w2", "b2")}


def _onehot(idx, n: int, dtype):
    """(…, n) one-hot rows of ``idx``; an index outside [0, n) gives a
    zero row, as ``jax.nn.one_hot`` does."""
    return (idx.long()[..., None]
            == torch.arange(n, device=idx.device)).to(dtype)


def _mlp(z, lp):
    z = F.relu(z @ lp["w1"] + lp["b1"])
    return F.relu(z @ lp["w2"] + lp["b2"])


def _gin_layer(h, lp, src, dst, n, edge_w=None, agg_mode="segment",
               lay=None):
    """h' = MLP((1+eps)·h + Σ_{j→i} h_j). Sum aggregator (GIN)."""
    if agg_mode == "onehot":
        msgs = torch.einsum("nf,en->ef", h, _onehot(src, n, h.dtype))
        if edge_w is not None:
            msgs = msgs * edge_w.to(h.dtype)[:, None]
        agg = torch.einsum("ef,en->nf", msgs, _onehot(dst, n, h.dtype))
    else:
        agg = aggregate(h, lay, edge_w)
    return _mlp((1.0 + lp["eps"]) * h + agg, lp)


def _layers(params, h, src, dst, edge_w=None, agg_mode="segment", lay=None):
    n = h.shape[0]
    if agg_mode != "onehot" and lay is None:
        lay = EdgeLayouts.of(src, dst, n)
    for i in range(params["layers"]["eps"].shape[0]):
        h = _gin_layer(h, _layer(params, i), src, dst, n, edge_w, agg_mode,
                       lay)
    return h


def gin_forward(params, x, src, dst, edge_w=None, lay=None):
    """Full-graph forward: x (N, d_in) -> node embeddings (N, d_hidden).
    ``lay``: ``EdgeLayouts`` of (src, dst), else looked up by
    ``EdgeLayouts.of``."""
    return _layers(params, x @ params["encoder"], src, dst, edge_w, lay=lay)


def gin_node_logits(params, x, src, dst, lay=None):
    return gin_forward(params, x, src, dst, lay=lay) @ params["classifier"]


def gin_graph_logits(params, x, src, dst, node_mask, edge_mask, lay=None):
    """Single padded graph -> graph-level logits (masked-sum readout)."""
    m = node_mask.to(x.dtype)[:, None]
    h = gin_forward(params, x * m, src, dst,
                    edge_w=edge_mask.to(x.dtype), lay=lay)
    return torch.sum(h * m, dim=0) @ params["classifier"]


def gin_graph_logits_batched(params, x, src, dst, node_mask, edge_mask,
                             lay=None):
    """G padded graphs -> (G, n_classes): ``gin_graph_logits`` of each.
    x (G, n, d_in), src/dst/edge_mask (G, E), node_mask (G, n). The
    graphs run as one flattened edge set (``lay``, else
    ``EdgeLayouts.of`` of the (G, E) tensors: edges outside their own
    graph's n nodes are dropped)."""
    g, n, _ = x.shape
    m = node_mask.to(x.dtype)[:, :, None]
    xf = (x * m).reshape(g * n, -1)
    if lay is None:
        lay = EdgeLayouts.of(src, dst, n)
    h = _layers(params, xf @ params["encoder"], None, None,
                edge_mask.reshape(-1).to(x.dtype), lay=lay)
    readout = torch.sum(h.reshape(g, n, -1) * m, dim=1)
    return readout @ params["classifier"]


def gin_sampled_logits(params, feats, edge_src, edge_dst, edge_mask,
                       n_seeds: int, agg_mode: str = "segment", lay=None):
    """Sampled-subgraph forward; logits for the first ``n_seeds`` nodes.
    ``lay``: the sample's ``SampledSubgraph.lay``."""
    h = feats @ params["encoder"]
    h = _layers(params, h, edge_src, edge_dst, edge_mask.to(h.dtype),
                agg_mode, lay)
    return h[:n_seeds] @ params["classifier"]


def _nll(logits, labels):
    """-log p(label) per row, in the reference's f32 log-softmax."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def gin_sampled_batched_loss(params, batch, cfg: GINConfig, n_seeds: int):
    """Batched sampled forward over (G, n, f) subgraph tensors; the loss
    over the first ``n_seeds`` nodes of each. ``segment``: the G
    subgraphs as one flattened edge set through K3; ``onehot``: the
    reference's batched one-hot gathers and scatters as einsums."""
    feats, src, dst = batch["feats"], batch["edge_src"], batch["edge_dst"]
    emask = batch["edge_mask"]
    g, n, _ = feats.shape
    h = feats @ params["encoder"]
    lay = batch.get("lay")
    if lay is None and cfg.agg != "onehot":
        lay = EdgeLayouts.of(src, dst, n)
    w = emask.to(h.dtype)
    axes = ("pod", "data", "model")  # the groups over the whole mesh
    for i in range(params["layers"]["eps"].shape[0]):
        lp = _layer(params, i)
        h = shard_hint(h, axes, None, None)
        if cfg.agg == "onehot":
            oh_src = _onehot(src, n, h.dtype)                    # (G,E,n)
            oh_dst = _onehot(dst, n, h.dtype)
            msgs = torch.einsum("gnf,gen->gef", h, oh_src)
            msgs = msgs * w[:, :, None]
            agg = torch.einsum("gef,gen->gnf", msgs, oh_dst)
        else:
            agg = aggregate(h.reshape(g * n, -1), lay, w).reshape(h.shape)
        h = shard_hint(_mlp((1.0 + lp["eps"]) * h + agg, lp), axes, None,
                       None)
    logits = h[:, :n_seeds] @ params["classifier"]              # (G,S,C)
    return torch.mean(_nll(logits, batch["labels"]))


def node_loss(params, batch, cfg: GINConfig):
    """The three losses read the edges' layouts from ``batch["lay"]``
    when the batch carries them."""
    logits = gin_node_logits(params, batch["x"],
                             shard_hint(batch["src"], DP),
                             shard_hint(batch["dst"], DP),
                             lay=batch.get("lay"))
    nll = _nll(logits, batch["labels"])
    mask = batch.get("train_mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def graph_loss(params, batch, cfg: GINConfig):
    logits = gin_graph_logits_batched(params, batch["x"], batch["src"],
                                      batch["dst"], batch["node_mask"],
                                      batch["edge_mask"],
                                      lay=batch.get("lay"))
    return torch.mean(_nll(logits, batch["labels"]))


def sampled_loss(params, batch, cfg: GINConfig):
    logits = gin_sampled_logits(params, batch["feats"], batch["edge_src"],
                                batch["edge_dst"], batch["edge_mask"],
                                batch["n_seeds"], agg_mode=cfg.agg,
                                lay=batch.get("lay"))
    return torch.mean(_nll(logits, batch["labels"]))
