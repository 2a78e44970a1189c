"""Mixture-of-Experts FFN with sort-based capacity dispatch (port of
``repro.models.moe``).

Dispatch as the reference: an f32 router, softmax, top-k (ties to the
lower index, as ``lax.top_k``: a stable descending sort), renormalised
weights; the Switch aux loss from exact per-expert counts; the flattened
(token, k) slots stable-sorted by expert, each slot's position within
its expert from the start of its expert's run (the exclusive cumsum of
the per-expert counts); a static (E, C, d) buffer where a slot at
position >= C is dropped; dense grouped expert products over
every expert; the slots' outputs gathered back (fill 0 where dropped),
weighted and summed per token.

Every differentiable gather is ``F.embedding`` (its backward on the card
sums repeated indices by a sort, without float atomics), and the buffer
is filled by a gather from the slot each entry holds, not by a scatter.
The combine adds a token's k contributions in the reference's order,
ascending expert id, starting from zero, in the compute dtype: the
reference's ``.at[t_s].add`` over the expert-sorted slots. The port
never uses ``index_add_``, whose float atomics on the card would add a
token's six (deepseek-v2) bf16 contributions in varying order, so two
identical steps give the same bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import silu
from .recsys import topk
from .sharding import DP, shard_hint


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(n_tokens * top_k / n_experts * capacity_factor) + 1
    return max(8, -(-c // 8) * 8)  # pad to 8, as the reference does


def _dispatch(x, router_w, top_k: int, c: int):
    """Route one shard's tokens x (T, d). Returns the (E, C, d) buffer,
    the combine's index (T, k) into the flattened (E*C) expert outputs
    (-1 where the slot was dropped) and weights (T, k), both in ascending
    expert order per token, and the aux loss."""
    t, d = x.shape
    e = router_w.shape[1]
    dev = x.device
    # (T, E): each token's logit for every expert (sharded, tokens on DP)
    logits = shard_hint(x.float() @ router_w.float(), DP, None)
    gates = torch.softmax(logits, dim=-1)
    topw, topi = topk(gates, top_k)                        # (T, k)
    topw = topw / topw.sum(dim=-1, keepdim=True)

    # aux loss (Switch-style): E * sum_e f_e * P_e
    me = gates.mean(dim=0)
    flat_e = topi.reshape(-1)                              # (T*k,)
    counts = torch.zeros(e, dtype=torch.long, device=dev).index_add(
        0, flat_e, torch.ones_like(flat_e))                # per expert
    ce_frac = counts.float() / (t * top_k)
    aux = e * (ce_frac * me).sum()

    order = torch.argsort(flat_e, stable=True)
    e_s = flat_e[order]
    starts = torch.cumsum(counts, 0) - counts              # sorted run starts
    pos_s = torch.arange(t * top_k, device=dev) - starts[e_s]
    pos = torch.empty_like(pos_s).index_put((order,), pos_s)  # per flat slot
    keep = pos < c
    slot = torch.where(keep, flat_e * c + pos, -1)         # into (E*C)

    # the buffer: entry (e, p) holds the token of the slot routed there
    # (a dropped slot writes the extra entry E*C, cut off after)
    flat_t = torch.arange(t, device=dev).repeat_interleave(top_k)
    src = torch.full((e * c + 1,), -1, dtype=torch.long, device=dev
                     ).index_put((torch.where(keep, slot, e * c),),
                                 flat_t)[:e * c]
    buf = F.embedding(src.clamp(min=0), x)
    buf = torch.where((src >= 0)[:, None], buf, 0).reshape(e, c, d)

    by_e = torch.argsort(topi, dim=1)                      # ascending expert
    return (buf, slot.reshape(t, top_k).gather(1, by_e),
            topw.gather(1, by_e), aux)


def _combine(y, slot, w, dtype):
    """y: (E, C, d) expert outputs. Each token's weighted outputs, added
    in ascending expert order from zero, in y's dtype."""
    e, c, d = y.shape
    out = torch.zeros((slot.shape[0], d), dtype=y.dtype, device=y.device)
    yf = y.reshape(e * c, d)
    for j in range(slot.shape[1]):
        s = slot[:, j]
        keep = s >= 0
        y_tok = torch.where(keep[:, None], F.embedding(s.clamp(min=0), yf),
                            0)
        out = out + y_tok * keep[:, None].to(y.dtype) \
            * w[:, j, None].to(y.dtype)
    return out.to(dtype)


def _experts(buf, w1, w3, w2):
    """Dense grouped expert products: buf (..., E, C, d) over every
    expert's w1/w3 (E, d, fe) and w2 (E, fe, d)."""
    up = silu(torch.einsum("...ecd,edf->...ecf", buf, w1)) * \
        torch.einsum("...ecd,edf->...ecf", buf, w3)
    return torch.einsum("...ecf,efd->...ecd", up, w2)


def moe_ffn(x, router_w, w1, w3, w2, *, top_k: int, capacity_factor: float,
            ep_on_model: bool, c_shard_dp: bool = False):
    """x: (T, d) -> (T, d), plus aux load-balancing loss.

    router_w: (d, E); w1/w3: (E, d, fe); w2: (E, fe, d). ``ep_on_model``
    and ``c_shard_dp`` choose the reference's sharding of the buffer;
    the port runs on one device, where they change nothing.
    """
    t, d = x.shape
    e = router_w.shape[1]
    c = moe_capacity(t, e, top_k, capacity_factor)
    espec = (("model", DP if c_shard_dp else None, None) if ep_on_model
             else (None, DP, None))
    buf, slot, w, aux = _dispatch(x, router_w, top_k, c)
    y = shard_hint(_experts(shard_hint(buf, *espec), w1, w3, w2), *espec)
    return _combine(y, slot, w, x.dtype), aux


def moe_ffn_vsharded(x, router_w, w1, w3, w2, *, top_k: int,
                     capacity_factor: float, n_virtual_shards: int):
    """Virtual-shard dispatch: tokens reshaped to (D, T/D, d) and each
    shard routed on its own, with per-shard capacity C_loc = ceil(T_loc
    * k / E * cf) (GShard semantics; a slightly different drop pattern
    than global dispatch). The expert products run over all shards at
    once; the aux loss is the mean of the shards'."""
    t, d = x.shape
    e = router_w.shape[1]
    dvs = n_virtual_shards
    t_loc = t // dvs
    c = moe_capacity(t_loc, e, top_k, capacity_factor)
    xg = shard_hint(x.reshape(dvs, t_loc, d), DP, None, None)
    shards = [_dispatch(xg[g], router_w, top_k, c) for g in range(dvs)]
    bufs = shard_hint(torch.stack([s[0] for s in shards]), DP, "model",
                      None, None)                          # (D, E, C, d)
    y = shard_hint(_experts(bufs, w1, w3, w2), DP, "model", None, None)
    out = torch.cat([_combine(y[g], s[1], s[2], y.dtype)
                     for g, s in enumerate(shards)])
    return out.to(x.dtype), torch.stack([s[3] for s in shards]).mean()
