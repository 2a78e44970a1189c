"""Decoder-only transformer: dense / GQA / MLA / SWA / MoE (port of
``repro.models.transformer``).

One model definition covers the five LM architectures. ``Transformer``
is an ``nn.Module`` holding the reference's stacked tree: ``embed``,
``layers/{ln1, ln2, attn/*, ffn/*}`` with a leading L axis,
``final_ln``, ``unembed`` (``to_tree()``, ``params_from_reference``:
``models/params.py``). The functions below take it (or any tree of
tensors at those paths) as ``params`` and read like the reference's.

Execution: the reference scans the stacked layers (``lax.scan``); the
port runs a Python loop over layer slices of the same stacked tensors.
With ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``
(non-reentrant): nothing inside a layer is kept for backward, the
reference's ``nothing_saveable``. ``remat_policy="dots"`` (no shipped
config sets it; the reference's ``dots_with_no_batch_dims_saveable``)
maps to a selective checkpoint that keeps the outputs of ``aten.mm`` and
``aten.bmm``: ``torch.einsum`` lowers batched and unbatched products
alike to ``bmm``, so the port keeps attention's batched products too.

Casts to the compute dtype happen where the reference casts: each use
of a weight reads ``w.to(cdt)``. The module keeps no cast copy, for the
forward or for decode: a cast is exact, so a kept copy would change only
the memory. Where the stored dtype is the compute dtype (mixtral,
deepseek-v2) the cast is free; with f32 weights and bf16 compute
(deepseek-7b, the minitrons) every decode step casts every weight.

Decode: ``decode_step`` writes the new position into the cache in place
(slot ``pos % S`` under a window, else ``pos``; ``length = min(pos + 1,
S)``) and returns the same cache, where the reference returns an updated
copy: at deepseek-7b's ``decode_32k`` one copy is 16 GB. MLA decodes
with the absorbed products (scores and values in the compressed
``kv_lora`` space), a different computation from ``forward``'s
up-projected keys and values.

Init: normal x 0.02 (ones for the norms, an f32 router), drawn from a
seeded ``torch.Generator`` leaf by leaf in the tree's order.
``param_specs``/``cache_specs`` are the reference's logical
PartitionSpecs, which the dry-run (``launch/dryrun.py``) filters against
its mesh and places each tensor by.
"""
from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..runtime import resolve_device, torch_dtype
from ..tree import tree_map, tree_map_with_path, walk
from .layers import (_inv_sqrt, chunked_attention, chunked_softmax_xent,
                     decode_attention, mlp_swiglu, rms_norm, rope)
from .moe import moe_ffn, moe_ffn_vsharded
from .params import Group, generator, normal
from .sharding import DP, P, is_dtensor, remat_context, shard_hint


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    attn_type: str = "gqa"          # "gqa" | "mla"
    window: Optional[int] = None    # SWA window (None = full attention)
    # MLA dims (DeepSeek-V2)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    mlp_type: str = "swiglu"        # "swiglu" (3 mats) | "relu2" (2 mats)
    # numerics / execution
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True
    remat_policy: str = "full"      # "full" | "dots" (save matmul outputs)
    fsdp: bool = False
    moe_c_shard_dp: bool = False    # shard MoE dispatch capacity over DP
    moe_virtual_shards: int = 0     # per-shard dispatch (see moe_ffn_vsharded)
    attn_chunk: int = 1024
    vocab_chunk: int = 16384
    rope_base: float = 10000.0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def qk_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    def pdt(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def cdt(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def n_params(self) -> int:
        """Exact parameter count, from the shapes (nothing allocated)."""
        return sum(x.numel() for _, x in walk(param_shapes(self)))

    def n_active_params(self) -> int:
        """Params touched per token (MoE counts top_k + shared experts)."""
        if not self.is_moe:
            return self.n_params()
        total = 0
        for path, x in walk(param_shapes(self)):
            n = x.numel()
            if "experts" in "/".join(path):
                n = n * self.top_k // self.n_experts
            total += n
        return total


# --------------------------------------------------------------------- init
def param_shapes(cfg: TransformerConfig):
    """The parameter tree as ``meta`` tensors: shapes and dtypes only."""
    pdt = cfg.pdt()
    L, d, H, Hkv, dh = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                        cfg.n_kv_heads, cfg.d_head)

    def m(*shape, dtype=pdt):
        return torch.empty(shape, dtype=dtype, device="meta")
    if cfg.attn_type == "mla":
        attn = {
            "w_uq": m(L, cfg.q_lora_rank or d, H, cfg.qk_dim),
            "w_dkv": m(L, d, cfg.kv_lora_rank + cfg.qk_rope_dim),
            "w_uk": m(L, cfg.kv_lora_rank, H, cfg.qk_nope_dim),
            "w_uv": m(L, cfg.kv_lora_rank, H, cfg.v_head_dim),
            "wo": m(L, H, cfg.v_head_dim, d),
        }
        if cfg.q_lora_rank:
            attn["w_dq"] = m(L, d, cfg.q_lora_rank)
    else:
        attn = {"wq": m(L, d, H, dh), "wk": m(L, d, Hkv, dh),
                "wv": m(L, d, Hkv, dh), "wo": m(L, H, dh, d)}
    if cfg.is_moe:
        fe = cfg.d_expert or cfg.d_ff
        ffn = {
            "router": m(L, d, cfg.n_experts, dtype=torch.float32),
            "experts_w1": m(L, cfg.n_experts, d, fe),
            "experts_w3": m(L, cfg.n_experts, d, fe),
            "experts_w2": m(L, cfg.n_experts, fe, d),
        }
        if cfg.n_shared:
            fs = cfg.n_shared * fe
            ffn.update({"shared_w1": m(L, d, fs), "shared_w3": m(L, d, fs),
                        "shared_w2": m(L, fs, d)})
    elif cfg.mlp_type == "relu2":
        ffn = {"w1": m(L, d, cfg.d_ff), "w2": m(L, cfg.d_ff, d)}
    else:
        ffn = {"w1": m(L, d, cfg.d_ff), "w3": m(L, d, cfg.d_ff),
               "w2": m(L, cfg.d_ff, d)}
    return {
        "embed": m(cfg.vocab, d),
        "layers": {"ln1": m(L, d), "ln2": m(L, d), "attn": attn,
                   "ffn": ffn},
        "final_ln": m(d),
        "unembed": m(d, cfg.vocab),
    }


# ----------------------------------------------------------------- sharding
def param_specs(cfg: TransformerConfig):
    """Logical PartitionSpecs (filtered against the mesh when placed)."""
    fs = "data" if cfg.fsdp else None
    ep_on_model = cfg.is_moe and cfg.n_experts >= 16
    if cfg.attn_type == "mla":
        attn = {
            "w_uq": P(None, fs, "model", None),
            "w_dkv": P(None, fs, None),
            "w_uk": P(None, fs, "model", None),
            "w_uv": P(None, fs, "model", None),
            "wo": P(None, "model", None, fs),
        }
        if cfg.q_lora_rank:
            attn["w_dq"] = P(None, fs, None)
    else:
        attn = {
            "wq": P(None, fs, "model", None),
            "wk": P(None, fs, "model", None) if cfg.n_kv_heads >= 16
            else P(None, fs, None, None),
            "wv": P(None, fs, "model", None) if cfg.n_kv_heads >= 16
            else P(None, fs, None, None),
            "wo": P(None, "model", None, fs),
        }
    if cfg.is_moe:
        if ep_on_model:
            ffn = {
                "router": P(None, fs, None),
                "experts_w1": P(None, "model", fs, None),
                "experts_w3": P(None, "model", fs, None),
                "experts_w2": P(None, "model", None, fs),
            }
        else:
            ffn = {
                "router": P(None, fs, None),
                "experts_w1": P(None, None, fs, "model"),
                "experts_w3": P(None, None, fs, "model"),
                "experts_w2": P(None, None, "model", fs),
            }
        if cfg.n_shared:
            ffn.update({
                "shared_w1": P(None, fs, "model"),
                "shared_w3": P(None, fs, "model"),
                "shared_w2": P(None, "model", fs),
            })
    elif cfg.mlp_type == "relu2":
        ffn = {
            "w1": P(None, fs, "model"),
            "w2": P(None, "model", fs),
        }
    else:
        ffn = {
            "w1": P(None, fs, "model"),
            "w3": P(None, fs, "model"),
            "w2": P(None, "model", fs),
        }
    return {
        "embed": P("model", fs),
        "layers": {
            "ln1": P(None, None),
            "ln2": P(None, None),
            "attn": attn,
            "ffn": ffn,
        },
        "final_ln": P(None),
        "unembed": P(fs, "model"),
    }


_NORMS = ("k=ln1", "k=ln2", "k=final_ln")


def init_params(cfg: TransformerConfig, seed: int = 0, device="cuda"):
    """The parameter tree on ``device``: normal x 0.02 in the leaf's dtype,
    ones for the norms."""
    dev = resolve_device(device)
    g = generator(seed, dev)

    def draw(path, like):
        if path[-1] in _NORMS:
            return torch.ones(like.shape, dtype=like.dtype, device=dev)
        return normal(g, like.shape, 0.02, dev, like.dtype)
    return tree_map_with_path(draw, param_shapes(cfg))


class Transformer(Group):
    """The LM: its config and its parameters at the reference's paths."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0,
                 device="cuda"):
        super().__init__(**init_params(cfg, seed, device))
        self.cfg = cfg

    def forward(self, tokens):
        return forward(self, tokens, self.cfg)

    def loss(self, batch, aux_weight: float = 0.01):
        return loss_fn(self, batch, self.cfg, aux_weight)

    def init_cache(self, batch: int, max_len: int):
        return init_cache(self.cfg, batch, max_len, device=self.embed.device)

    def decode_step(self, cache, tokens, pos):
        return decode_step(self, cache, tokens, pos, self.cfg)


def _tree(p):
    return p.to_tree() if hasattr(p, "to_tree") else p


def _layer_slices(params, n_layers: int):
    """Layer i's parameters: index i of every stacked leaf (views)."""
    lt = _tree(params["layers"])
    return [tree_map(lambda a, i=i: a[i], lt) for i in range(n_layers)]


# ------------------------------------------------------------------ forward
def _attention_block(x, ap, cfg: TransformerConfig, positions):
    cdt = cfg.cdt()
    if cfg.attn_type == "mla":
        if cfg.q_lora_rank:
            cq = torch.einsum("bsd,dr->bsr", x, ap["w_dq"].to(cdt))
            q = torch.einsum("bsr,rhk->bshk", cq, ap["w_uq"].to(cdt))
        else:
            q = torch.einsum("bsd,dhk->bshk", x, ap["w_uq"].to(cdt))
        q = shard_hint(q, DP, None, "model", None)
        qn, qr = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
        qr = rope(qr, positions, cfg.rope_base)
        ckv_full = torch.einsum("bsd,dr->bsr", x, ap["w_dkv"].to(cdt))
        ckv = ckv_full[..., :cfg.kv_lora_rank]
        kr = rope(ckv_full[..., cfg.kv_lora_rank:][:, :, None, :],
                  positions, cfg.rope_base)                # (B,S,1,rope)
        kn = torch.einsum("bsr,rhn->bshn", ckv, ap["w_uk"].to(cdt))
        kn = shard_hint(kn, DP, None, "model", None)
        v = torch.einsum("bsr,rhn->bshn", ckv, ap["w_uv"].to(cdt))
        v = shard_hint(v, DP, None, "model", None)
        q_full = torch.cat([qn, qr], dim=-1)
        k_full = torch.cat(
            [kn, kr.expand(*kn.shape[:-1], cfg.qk_rope_dim)], dim=-1)
        out = chunked_attention(q_full, k_full, v, causal=True,
                                window=cfg.window, chunk=cfg.attn_chunk)
        return torch.einsum("bshv,hvd->bsd", out, ap["wo"].to(cdt))
    q = torch.einsum("bsd,dhk->bshk", x, ap["wq"].to(cdt))
    k = torch.einsum("bsd,dhk->bshk", x, ap["wk"].to(cdt))
    v = torch.einsum("bsd,dhk->bshk", x, ap["wv"].to(cdt))
    q = shard_hint(q, DP, None, "model", None)
    q = rope(q, positions, cfg.rope_base)
    k = rope(k, positions, cfg.rope_base)
    out = chunked_attention(q, k, v, causal=True, window=cfg.window,
                            chunk=cfg.attn_chunk)
    return torch.einsum("bshv,hvd->bsd", out, ap["wo"].to(cdt))


def _ffn_block(x, fp, cfg: TransformerConfig):
    b, s, d = x.shape
    cdt = cfg.cdt()
    if not cfg.is_moe:
        if cfg.mlp_type == "relu2":
            z = F.relu(torch.einsum("...d,df->...f", x,
                                    fp["w1"].to(cdt))).square()
            return torch.einsum("...f,fd->...d", z, fp["w2"].to(cdt)), 0.0
        return mlp_swiglu(x, fp["w1"].to(cdt), fp["w3"].to(cdt),
                          fp["w2"].to(cdt)), 0.0
    xt = x.reshape(b * s, d)
    experts = (fp["experts_w1"].to(cdt), fp["experts_w3"].to(cdt),
               fp["experts_w2"].to(cdt))
    if cfg.moe_virtual_shards > 1:
        out, aux = moe_ffn_vsharded(
            xt, fp["router"], *experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            n_virtual_shards=cfg.moe_virtual_shards)
    else:
        out, aux = moe_ffn(xt, fp["router"], *experts, top_k=cfg.top_k,
                           capacity_factor=cfg.capacity_factor,
                           ep_on_model=cfg.n_experts >= 16,
                           c_shard_dp=cfg.moe_c_shard_dp)
    out = shard_hint(out, DP, None).reshape(b, s, d)  # tokens back on DP
    if cfg.n_shared:
        out = out + mlp_swiglu(x, fp["shared_w1"].to(cdt),
                               fp["shared_w3"].to(cdt),
                               fp["shared_w2"].to(cdt))
    return out, aux


def _layer(x, aux, lp, cfg: TransformerConfig, positions):
    h = rms_norm(x, lp["ln1"].to(cfg.cdt()))
    x = x + _attention_block(h, lp["attn"], cfg, positions)
    h = rms_norm(x, lp["ln2"].to(cfg.cdt()))
    f, aux_l = _ffn_block(h, lp["ffn"], cfg)
    x = shard_hint(x + f, DP, None, None)
    return x, aux + aux_l


_DOTS = partial(create_selective_checkpoint_contexts,
                [torch.ops.aten.mm.default, torch.ops.aten.bmm.default])


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> (final hidden states (B, S, d) in compute dtype,
    the f32 sum of the layers' MoE aux losses)."""
    cdt = cfg.cdt()
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device)
    x = F.embedding(tokens, embed).to(cdt)
    x = shard_hint(x, DP, None, None)
    positions = torch.arange(tokens.shape[1], device=embed.device)
    aux = torch.zeros((), dtype=torch.float32, device=embed.device)
    for lp in _layer_slices(params, cfg.n_layers):
        if cfg.remat:
            x, aux = checkpoint(_layer, x, aux, lp, cfg, positions,
                                use_reentrant=False,
                                context_fn=remat_context(
                                    _DOTS if cfg.remat_policy == "dots"
                                    else None))
        else:
            x, aux = _layer(x, aux, lp, cfg, positions)
    x = rms_norm(x, params["final_ln"].to(cdt))
    return x, aux


def loss_fn(params, batch, cfg: TransformerConfig, aux_weight: float = 0.01):
    x, aux = forward(params, batch["tokens"], cfg)
    b, s, d = x.shape
    labels = torch.as_tensor(batch["labels"], device=x.device)
    # the vocab chunks slice the whole unembedding (sharded, it is
    # gathered first, as XLA gathers it for its dynamic slices)
    ce = chunked_softmax_xent(x.reshape(b * s, d),
                              shard_hint(params["unembed"].to(cfg.cdt()),
                                         None, None),
                              labels.reshape(-1), chunk=cfg.vocab_chunk)
    return ce + aux_weight * aux / max(cfg.n_layers, 1)


# ------------------------------------------------------------------- decode
def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device="cuda"):
    """KV cache tree. GQA: (L,B,S,Hkv,dh) k/v (a rolling buffer of
    ``min(max_len, window)`` positions under SWA); MLA: the compressed
    (L,B,S,kv_lora) ``ckv`` and (L,B,S,rope) ``kr``."""
    dev = resolve_device(device)
    cdt = cfg.cdt()
    s = min(max_len, cfg.window) if cfg.window else max_len

    def z(*shape):
        return torch.zeros(shape, dtype=cdt, device=dev)
    if cfg.attn_type == "mla":
        return {"ckv": z(cfg.n_layers, batch, s, cfg.kv_lora_rank),
                "kr": z(cfg.n_layers, batch, s, cfg.qk_rope_dim)}
    return {"k": z(cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.d_head),
            "v": z(cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.d_head)}


def cache_specs(cfg: TransformerConfig):
    """Sequence dim sharded over "model" (cache SP) unless SWA rolling."""
    sdim = None if cfg.window else "model"
    if cfg.attn_type == "mla":
        return {"ckv": P(None, DP, sdim, None), "kr": P(None, DP, sdim, None)}
    return {"k": P(None, DP, sdim, None, None),
            "v": P(None, DP, sdim, None, None)}


def _decode_ffn(x, lp, cfg):
    h2 = rms_norm(x, lp["ln2"].to(cfg.cdt()))
    f, _ = _ffn_block(h2[:, None], lp["ffn"], cfg)
    return x + f[:, 0]


def _write_slot(cache_l, slot: int, new):
    """``cache_l[:, slot] = new``. The dry-run's position-sharded cache
    (a ``DTensor``) takes it as one ``index_copy_`` on its shards: a
    select on that axis would gather it."""
    if is_dtensor(cache_l):
        cache_l.index_copy_(1, torch.full((1,), slot, dtype=torch.long,
                                          device=cache_l.device),
                            new[:, None])
    else:
        cache_l[:, slot] = new


def _decode_layer_gqa(x, lp, cache, i, pos, slot, cfg):
    cdt = cfg.cdt()
    h = rms_norm(x, lp["ln1"].to(cdt))
    ap = lp["attn"]
    q = torch.einsum("bd,dhk->bhk", h, ap["wq"].to(cdt))
    k = torch.einsum("bd,dhk->bhk", h, ap["wk"].to(cdt))
    v = torch.einsum("bd,dhk->bhk", h, ap["wv"].to(cdt))
    posv = torch.full((x.shape[0], 1), pos, device=x.device)
    q = rope(q[:, None], posv, cfg.rope_base)[:, 0]
    k = rope(k[:, None], posv, cfg.rope_base)[:, 0]
    kc, vc = cache["k"][i], cache["v"][i]
    _write_slot(kc, slot, k)
    _write_slot(vc, slot, v)
    out = decode_attention(q, kc, vc, length=min(pos + 1, kc.shape[1]),
                           window=None)  # rolling buffer already bounds SWA
    x = x + torch.einsum("bhv,hvd->bd", out, ap["wo"].to(cdt))
    return _decode_ffn(x, lp, cfg)


def _decode_layer_mla(x, lp, cache, i, pos, slot, cfg):
    """MLA decode with the absorbed-matmul trick: scores and values live in
    the compressed kv_lora space; w_uk/w_uv are absorbed into q/out."""
    cdt = cfg.cdt()
    h = rms_norm(x, lp["ln1"].to(cdt))
    ap = lp["attn"]
    if cfg.q_lora_rank:
        cq = torch.einsum("bd,dr->br", h, ap["w_dq"].to(cdt))
        q = torch.einsum("br,rhk->bhk", cq, ap["w_uq"].to(cdt))
    else:
        q = torch.einsum("bd,dhk->bhk", h, ap["w_uq"].to(cdt))
    qn, qr = q[..., :cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    posv = torch.full((x.shape[0], 1), pos, device=x.device)
    qr = rope(qr[:, None], posv, cfg.rope_base)[:, 0]     # (B,H,rope)
    ckv_new_full = torch.einsum("bd,dr->br", h, ap["w_dkv"].to(cdt))
    kr_new = rope(ckv_new_full[:, None, None, cfg.kv_lora_rank:], posv,
                  cfg.rope_base)[:, 0, 0]                  # (B,rope)
    ckv, krc = cache["ckv"][i], cache["kr"][i]
    _write_slot(ckv, slot, ckv_new_full[:, :cfg.kv_lora_rank])
    _write_slot(krc, slot, kr_new)
    # absorb w_uk into q: q_lat (B,H,kvr)
    q_lat = torch.einsum("bhn,rhn->bhr", qn, ap["w_uk"].to(cdt))
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float()) +
              torch.einsum("bhr,bsr->bhs", qr.float(), krc.float())) \
        * _inv_sqrt(cfg.qk_dim)
    length = min(pos + 1, ckv.shape[1])
    mask = torch.arange(ckv.shape[1], device=x.device) < length
    scores = torch.where(mask[None, None, :], scores, -math.inf)
    p = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhs,bsr->bhr", p, ckv.float()).to(cdt)
    out = torch.einsum("bhr,rhv->bhv", o_lat, ap["w_uv"].to(cdt))
    x = x + torch.einsum("bhv,hvd->bd", out, ap["wo"].to(cdt))
    return _decode_ffn(x, lp, cfg)


@torch.no_grad()
def decode_step(params, cache, tokens, pos: int, cfg: TransformerConfig):
    """One decode step. tokens: (B,) ints; pos: the current position (an
    int, the same for the whole batch). Writes the position into
    ``cache`` in place; returns (logits (B, V), cache)."""
    cdt = cfg.cdt()
    pos = int(pos)
    embed = params["embed"]
    x = F.embedding(torch.as_tensor(tokens, device=embed.device),
                    embed).to(cdt)
    slot = pos % cache[next(iter(cache))].shape[2] if cfg.window else pos
    layer_fn = (_decode_layer_mla if cfg.attn_type == "mla"
                else _decode_layer_gqa)
    for i, lp in enumerate(_layer_slices(params, cfg.n_layers)):
        x = layer_fn(x, lp, cache, i, pos, slot, cfg)
    x = rms_norm(x, params["final_ln"].to(cdt))
    logits = torch.einsum("bd,dv->bv", x, params["unembed"].to(cdt))
    return logits, cache
