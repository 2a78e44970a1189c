"""Step functions the dry-run runs, one per (family, kind) (port of
``repro.launch.steps``).

Each builder returns a ``LoweredStep``: the step function, its
arguments and the logical PartitionSpecs of every argument. Where the
reference's arguments are ``ShapeDtypeStruct`` stand-ins, the port's are
``meta`` tensors of the same shapes and dtypes (nothing is allocated);
the parameters are the port's modules (``Transformer``, ``GIN``, the
recsys modules) built on ``meta``, and the optimizer state holds ``meta``
moments. Two arguments are host values, because the port reads them on
the host: the optimizer's ``step`` (a CPU int32 scalar, as in every port
step) and the decode position (a CPU int32 scalar; the dry-run's decode
writes the last position, ``seq_len - 1``).

GIN aggregates through K3's layouts, as the port's trainer does: on
``meta`` edges they take K3's largest size for the edge count
(``EdgeLayouts._bound``: layouts need host reads of the edges) and K3
counts its own traffic. The ranking sweep is built against the mesh in
``launch/dryrun.py``, as in the reference. ``meta`` (``model_flops_per_step`` and the rest) is the
reference's, formula for formula.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import torch

from ..configs.base import ArchSpec
from ..graph.sampler import khop_sizes
from ..models import gnn as gnn_m
from ..models import recsys as rs
from ..models import transformer as tf_m
from ..models.sharding import DP, P, shard_hint
from ..tree import tree_map
from ..train.optimizer import AdamWConfig, init_opt_state, opt_state_specs
from ..train.train_step import make_train_step

EDGE = (("pod", "data", "model"),)  # edge arrays shard over the whole mesh


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


@dataclasses.dataclass
class LoweredStep:
    name: str
    fn: Any                    # the step: fn(*args)
    args: tuple                # meta tensors, modules on meta, host scalars
    in_specs: tuple            # logical PartitionSpec trees, one per arg
    static_argnums: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


def _replicated(params):
    return tree_map(lambda _: P(), params.to_tree())


# ------------------------------------------------------------------------ LM
def _lm_abstract_state(cfg):
    params = tf_m.Transformer(cfg, device="meta")
    return params, init_opt_state(params)


def lm_train(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = spec.config
    b, s = shape["global_batch"], shape["seq_len"]
    params, opt = _lm_abstract_state(cfg)
    step = make_train_step(partial(tf_m.loss_fn, cfg=cfg), AdamWConfig())
    batch = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    pspecs = tf_m.param_specs(cfg)
    return LoweredStep(
        name=f"{cfg.name}-train", fn=step,
        args=(params, opt, batch),
        in_specs=(pspecs, opt_state_specs(pspecs),
                  {"tokens": P(DP, None), "labels": P(DP, None)}),
        meta={"model_flops_per_step": 6 * cfg.n_active_params() * b * s},
    )


def lm_prefill(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = spec.config
    b, s = shape["global_batch"], shape["seq_len"]
    params, _ = _lm_abstract_state(cfg)

    @torch.no_grad()
    def prefill(params, tokens):
        x, _ = tf_m.forward(params, tokens, cfg)
        # next-token logits for the last position of every sequence
        return torch.einsum("bd,dv->bv", x[:, -1],
                            params["unembed"].to(cfg.cdt()))

    return LoweredStep(
        name=f"{cfg.name}-prefill", fn=prefill,
        args=(params, _meta((b, s), torch.int32)),
        in_specs=(tf_m.param_specs(cfg), P(DP, None)),
        meta={"model_flops_per_step": 2 * cfg.n_active_params() * b * s},
    )


def lm_decode(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = spec.config
    b, s = shape["global_batch"], shape["seq_len"]
    params, _ = _lm_abstract_state(cfg)
    cache = tf_m.init_cache(cfg, b, s, device="meta")

    def step(params, cache, tokens, pos):
        return tf_m.decode_step(params, cache, tokens, pos, cfg)

    return LoweredStep(
        name=f"{cfg.name}-decode", fn=step,
        args=(params, cache, _meta((b,), torch.int32),
              torch.tensor(s - 1, dtype=torch.int32)),
        in_specs=(tf_m.param_specs(cfg), tf_m.cache_specs(cfg), P(DP), P()),
        meta={"model_flops_per_step": 2 * cfg.n_active_params() * b},
    )


# ----------------------------------------------------------------------- GNN
def _gnn_cfg(spec: ArchSpec, shape: dict):
    from ..configs.gin_tu import for_shape
    return for_shape(shape)


def _gin(cfg):
    params = gnn_m.GIN(cfg, device="meta")
    return params, init_opt_state(params), _replicated(params)


def gnn_full_train(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = _gnn_cfg(spec, shape)
    n, e = shape["n_nodes"], shape["n_edges"]
    # pad edges to a shardable multiple; pad edges use dst=N, which the
    # aggregation drops, so results are unchanged
    e = -(-e // 4096) * 4096
    params, opt, pspec = _gin(cfg)
    step = make_train_step(partial(gnn_m.node_loss, cfg=cfg), AdamWConfig())
    batch = {
        "x": _meta((n, cfg.d_in), torch.float32),
        "src": _meta((e,), torch.int32),
        "dst": _meta((e,), torch.int32),
        "labels": _meta((n,), torch.int32),
        "train_mask": _meta((n,), torch.float32),
    }
    bspec = {"x": P(DP, None), "src": P(EDGE[0]), "dst": P(EDGE[0]),
             "labels": P(DP), "train_mask": P(DP)}
    # GIN layer FLOPs: 2*E*dh (aggregate) + 2*N*dh*dh*2 (MLP) per layer
    dh = cfg.d_hidden
    mf = cfg.n_layers * (2 * e * dh + 4 * n * dh * dh) + 2 * n * cfg.d_in * dh
    return LoweredStep(
        name=f"{cfg.name}-full-train", fn=step, args=(params, opt, batch),
        in_specs=(pspec, opt_state_specs(pspec), bspec),
        meta={"model_flops_per_step": 3 * mf},  # fwd + 2x bwd
    )


def gnn_sampled_train(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = _gnn_cfg(spec, shape)
    bn, fanout = shape["batch_nodes"], tuple(shape["fanout"])
    n_tot, e_tot = khop_sizes(bn, fanout)
    params, opt, pspec = _gin(cfg)
    step = make_train_step(
        lambda p, b: gnn_m.sampled_loss(p, {**b, "n_seeds": bn}, cfg),
        AdamWConfig())
    batch = {
        "feats": _meta((n_tot, cfg.d_in), torch.float32),
        "edge_src": _meta((e_tot,), torch.int32),
        "edge_dst": _meta((e_tot,), torch.int32),
        "edge_mask": _meta((e_tot,), torch.bool),
        "labels": _meta((bn,), torch.int32),
    }
    bspec = {"feats": P(DP, None), "edge_src": P(EDGE[0]),
             "edge_dst": P(EDGE[0]), "edge_mask": P(EDGE[0]), "labels": P(DP)}
    dh = cfg.d_hidden
    mf = cfg.n_layers * (2 * e_tot * dh + 4 * n_tot * dh * dh) \
        + 2 * n_tot * cfg.d_in * dh
    return LoweredStep(
        name=f"{cfg.name}-sampled-train", fn=step, args=(params, opt, batch),
        in_specs=(pspec, opt_state_specs(pspec), bspec),
        meta={"model_flops_per_step": 3 * mf,
              "note": "sampler runs host-side; see graph.sampler"},
    )


def gnn_graph_train(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = _gnn_cfg(spec, shape)
    b, nn, ne = shape["global_batch"], shape["n_nodes"], shape["n_edges"]
    params, opt, pspec = _gin(cfg)
    step = make_train_step(partial(gnn_m.graph_loss, cfg=cfg), AdamWConfig())
    batch = {
        "x": _meta((b, nn, cfg.d_in), torch.float32),
        "src": _meta((b, ne), torch.int32),
        "dst": _meta((b, ne), torch.int32),
        "node_mask": _meta((b, nn), torch.float32),
        "edge_mask": _meta((b, ne), torch.float32),
        "labels": _meta((b,), torch.int32),
    }
    bspec = {k: (P(DP, None, None) if v.dim() == 3 else
                 P(DP, None) if v.dim() == 2 else P(DP))
             for k, v in batch.items()}
    dh = cfg.d_hidden
    mf = b * (cfg.n_layers * (2 * ne * dh + 4 * nn * dh * dh)
              + 2 * nn * cfg.d_in * dh)
    return LoweredStep(
        name=f"{cfg.name}-graph-train", fn=step, args=(params, opt, batch),
        in_specs=(pspec, opt_state_specs(pspec), bspec),
        meta={"model_flops_per_step": 3 * mf},
    )


# -------------------------------------------------------------------- recsys
def _recsys_model(spec: ArchSpec):
    """(loss, logits, params on meta, param specs)."""
    cfg = spec.config
    params = rs.build(cfg, device="meta")
    if isinstance(cfg, rs.DLRMConfig):
        off = rs.unified_table_offsets(cfg.vocab_sizes)
        return (partial(rs.dlrm_loss, cfg=cfg, offsets=off),
                partial(rs.dlrm_logits, cfg=cfg, offsets=off),
                params, rs.dlrm_specs(cfg))
    if isinstance(cfg, rs.DCNConfig):
        off = rs.unified_table_offsets(cfg.vocab_sizes)
        return (partial(rs.dcn_loss, cfg=cfg, offsets=off),
                partial(rs.dcn_logits, cfg=cfg, offsets=off),
                params, rs.dcn_specs(cfg))
    if isinstance(cfg, rs.BSTConfig):
        return (partial(rs.bst_loss, cfg=cfg),
                partial(rs.bst_logits, cfg=cfg), params, rs.bst_specs(cfg))
    if isinstance(cfg, rs.TwoTowerConfig):
        return (partial(rs.twotower_loss, cfg=cfg), None, params,
                rs.twotower_specs(cfg))
    raise TypeError(cfg)


def _recsys_batch_specs(spec: ArchSpec, b: int):
    cfg = spec.config
    if isinstance(cfg, (rs.DLRMConfig, rs.DCNConfig)):
        batch = {"dense": _meta((b, cfg.n_dense), torch.float32),
                 "sparse": _meta((b, cfg.n_sparse), torch.int32),
                 "label": _meta((b,), torch.float32)}
        bs = {"dense": P(DP, None), "sparse": P(DP, None), "label": P(DP)}
    elif isinstance(cfg, rs.BSTConfig):
        batch = {"hist": _meta((b, cfg.seq_len), torch.int32),
                 "target": _meta((b,), torch.int32),
                 "label": _meta((b,), torch.float32)}
        bs = {"hist": P(DP, None), "target": P(DP), "label": P(DP)}
    else:
        batch = {"user": _meta((b,), torch.int32),
                 "item": _meta((b,), torch.int32)}
        bs = {"user": P(DP), "item": P(DP)}
    return batch, bs


def _recsys_flops(spec: ArchSpec, b: int) -> int:
    cfg = spec.config
    if isinstance(cfg, rs.DLRMConfig):
        mlps = sum(cfg.bot_mlp[i] * cfg.bot_mlp[i + 1]
                   for i in range(len(cfg.bot_mlp) - 1))
        top_in = cfg.n_interactions + cfg.embed_dim
        dims = (top_in,) + cfg.top_mlp
        mlps += sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        inter = (cfg.n_sparse + 1) ** 2 * cfg.embed_dim
        return 2 * b * (mlps + inter)
    if isinstance(cfg, rs.DCNConfig):
        d0 = cfg.d_input
        cross = cfg.n_cross_layers * d0 * d0
        dims = (d0,) + cfg.deep_mlp
        deep = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return 2 * b * (cross + deep + (d0 + cfg.deep_mlp[-1]))
    if isinstance(cfg, rs.BSTConfig):
        d, s = cfg.embed_dim, cfg.seq_len + 1
        blk = cfg.n_blocks * (4 * s * d * d + 2 * s * s * d + 8 * s * d * d)
        dims = (s * d,) + cfg.mlp + (1,)
        mlp = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        return 2 * b * (blk + mlp)
    cfg2: rs.TwoTowerConfig = cfg
    dims = (cfg2.embed_dim,) + cfg2.tower_mlp
    tower = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
    return 2 * b * (2 * tower + b * cfg2.tower_mlp[-1])


def recsys_train(spec: ArchSpec, shape: dict) -> LoweredStep:
    b = shape["global_batch"]
    loss, _logits, params, pspecs = _recsys_model(spec)
    step = make_train_step(loss, AdamWConfig())
    batch, bs = _recsys_batch_specs(spec, b)
    return LoweredStep(
        name=f"{spec.arch_id}-train", fn=step,
        args=(params, init_opt_state(params), batch),
        in_specs=(pspecs, opt_state_specs(pspecs), bs),
        meta={"model_flops_per_step": 3 * _recsys_flops(spec, b)},
    )


def recsys_serve(spec: ArchSpec, shape: dict) -> LoweredStep:
    b = shape["global_batch"]
    cfg = spec.config
    _loss, logits, params, pspecs = _recsys_model(spec)
    batch, bs = _recsys_batch_specs(spec, b)
    batch.pop("label", None)
    bs.pop("label", None)
    if isinstance(cfg, rs.TwoTowerConfig):
        def fn(params, batch):
            u = rs.user_embed(params, batch["user"])
            v = rs.item_embed(params, batch["item"])
            return torch.sum(u * v, dim=-1)
    elif isinstance(cfg, rs.BSTConfig):
        def fn(params, batch):
            return logits(params, batch["hist"], batch["target"])
    else:
        def fn(params, batch):
            return logits(params, batch["dense"], batch["sparse"])
    return LoweredStep(
        name=f"{spec.arch_id}-serve", fn=torch.no_grad()(fn),
        args=(params, batch), in_specs=(pspecs, bs),
        meta={"model_flops_per_step": _recsys_flops(spec, b) // 3},
    )


def recsys_retrieval(spec: ArchSpec, shape: dict) -> LoweredStep:
    cfg = spec.config
    b, c = shape["global_batch"], shape["n_candidates"]
    _loss, logits, params, pspecs = _recsys_model(spec)
    cand_spec = P(DP)
    if isinstance(cfg, rs.TwoTowerConfig):
        def fn(params, users, cands):
            return rs.retrieval_topk(params, users, cands, k=100)
        args = (params, _meta((b,), torch.int32), _meta((c,), torch.int32))
        specs = (pspecs, P(None), cand_spec)
        flops = 2 * c * (sum((cfg.embed_dim,) + cfg.tower_mlp) ** 1)
    elif isinstance(cfg, rs.BSTConfig):
        def fn(params, hist, cands):
            # the broadcast history sharded as the candidates (XLA places
            # it so), not replicated
            h = shard_hint(hist.expand((c,) + tuple(hist.shape[1:])),
                           DP, None)
            return rs.topk(logits(params, h, cands), 100)
        args = (params, _meta((1, cfg.seq_len), torch.int32),
                _meta((c,), torch.int32))
        specs = (pspecs, P(None, None), cand_spec)
        flops = _recsys_flops(spec, c) // 3
    else:
        def fn(params, dense, sparse_user, cands):
            # the user's broadcast features sharded as the candidates
            d = shard_hint(dense.expand(c, dense.shape[1]), DP, None)
            su = shard_hint(sparse_user.expand(c, sparse_user.shape[1]),
                            DP, None)
            ids = torch.cat([cands[:, None], su[:, 1:]], dim=1)
            return rs.topk(logits(params, d, ids), 100)
        args = (params, _meta((1, cfg.n_dense), torch.float32),
                _meta((1, cfg.n_sparse), torch.int32),
                _meta((c,), torch.int32))
        specs = (pspecs, P(None, None), P(None, None), cand_spec)
        flops = _recsys_flops(spec, c) // 3
    return LoweredStep(
        name=f"{spec.arch_id}-retrieval", fn=torch.no_grad()(fn), args=args,
        in_specs=specs, meta={"model_flops_per_step": int(flops)},
    )


# ------------------------------------------------------------------- ranking
def ranking_sweep(spec: ArchSpec, shape: dict, n_devices: int,
                  mode: str = "baseline") -> LoweredStep:
    """The paper's distributed power sweep. Modes: baseline=replicated
    psum; dual_blocked=block-owned scatter + all-gather (2x less
    traffic); +bf16 halves vector bytes (fp32 norm/residual)."""
    n, e, v = shape["n_nodes"], shape["n_edges"], shape["n_vectors"]
    dtype = torch.bfloat16 if "bf16" in mode else torch.float32
    e_loc = -(-e // n_devices)
    espec = P(("pod", "data", "model"), None)
    meta = {"model_flops_per_step": 4 * e * v + 6 * n * v, "mode": mode}
    edge_args = (
        _meta((n_devices, e_loc), torch.int32),   # src
        _meta((n_devices, e_loc), torch.int32),   # dst
        _meta((n_devices, e_loc), dtype),         # w
        _meta((n_devices, e_loc), torch.bool),    # mask
    )
    if "dual_blocked" in mode:
        n_h = n
        if "compact" in mode:
            n_h = int(n * (1 - shape.get("dangling_frac", 0.0)))
        nb = -(-n_h // n_devices)
        vec = _meta((n_devices, nb, v) if v > 1 else (n_devices, nb), dtype)
        args = (vec,) + edge_args + edge_args  # a-partition + h-partition
        in_specs = (espec,) + (espec,) * 8
    else:
        vec = _meta((n, v) if v > 1 else (n,), dtype)
        args = (vec,) + edge_args
        in_specs = (P(),) + (espec,) * 4
    return LoweredStep(
        name=f"hits-{shape['kind']}", fn=None,  # built against the mesh
        args=args, in_specs=in_specs, meta=meta,
    )


def gnn_sampled_train_dp(spec: ArchSpec, shape: dict,
                         mode: str = "") -> LoweredStep:
    """Per-device independent subgraphs (embarrassingly data-parallel
    minibatch GNN) instead of one global edge-sharded block. Cross-device
    traffic collapses to the gradient all-reduce. With "+onehot",
    aggregation becomes an einsum."""
    cfg = _gnn_cfg(spec, shape)
    if "onehot" in mode:
        cfg = dataclasses.replace(cfg, agg="onehot")
    bn, fanout = shape["batch_nodes"], tuple(shape["fanout"])
    n_groups = 256                       # one subgraph per device
    seeds_per = max(bn // n_groups, 1)
    n_tot, e_tot = khop_sizes(seeds_per, fanout)
    params, opt, pspec = _gin(cfg)

    def loss_batched(p, b):
        return gnn_m.gin_sampled_batched_loss(p, b, cfg, seeds_per)

    step = make_train_step(loss_batched, AdamWConfig())
    g = n_groups
    batch = {
        "feats": _meta((g, n_tot, cfg.d_in), torch.float32),
        "edge_src": _meta((g, e_tot), torch.int32),
        "edge_dst": _meta((g, e_tot), torch.int32),
        "edge_mask": _meta((g, e_tot), torch.bool),
        "labels": _meta((g, seeds_per), torch.int32),
    }
    bspec = {k: P(EDGE[0], None) for k in batch}
    dh = cfg.d_hidden
    mf = g * (cfg.n_layers * (2 * e_tot * dh + 4 * n_tot * dh * dh)
              + 2 * n_tot * cfg.d_in * dh)
    return LoweredStep(
        name=f"{cfg.name}-sampled-train-dp", fn=step,
        args=(params, opt, batch),
        in_specs=(pspec, opt_state_specs(pspec), bspec),
        meta={"model_flops_per_step": 3 * mf},
    )


# ------------------------------------------------------------------ registry
def _apply_lm_mode(spec: ArchSpec, mode: str) -> ArchSpec:
    cfg = spec.config
    for tok in mode.split("+"):
        if tok == "moe_cshard":
            cfg = dataclasses.replace(cfg, moe_c_shard_dp=True)
        elif tok == "moe_vshard":
            cfg = dataclasses.replace(cfg, moe_virtual_shards=16)
        elif tok == "remat_dots":
            cfg = dataclasses.replace(cfg, remat_policy="dots")
        elif tok.startswith("attn_chunk"):
            cfg = dataclasses.replace(cfg, attn_chunk=int(tok.split("=")[1]))
    return dataclasses.replace(spec, config=cfg)


def build_step(spec: ArchSpec, shape_name: str, n_devices: int = 256,
               mode: str = "baseline") -> LoweredStep:
    shape = spec.shapes[shape_name]
    kind = shape["kind"]
    if spec.family == "lm":
        if mode != "baseline":
            spec = _apply_lm_mode(spec, mode)
        return {"train": lm_train, "prefill": lm_prefill,
                "decode": lm_decode}[kind](spec, shape)
    if spec.family == "gnn":
        if kind == "gnn_sampled" and "dp_subgraphs" in mode:
            return gnn_sampled_train_dp(spec, shape, mode)
        return {"gnn_full": gnn_full_train, "gnn_sampled": gnn_sampled_train,
                "gnn_graph": gnn_graph_train}[kind](spec, shape)
    if spec.family == "recsys":
        return {"train": recsys_train, "serve": recsys_serve,
                "retrieval": recsys_retrieval}[kind](spec, shape)
    if spec.family == "ranking":
        return ranking_sweep(spec, shape, n_devices, mode=mode)
    raise ValueError(spec.family)
