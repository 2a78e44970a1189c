"""Shared neural layers (port of ``repro.models.layers``): RMSNorm,
RoPE, memory-bounded (flash-style) attention by online softmax over KV
chunks, single-position decode attention, the MLPs and vocab-chunked
cross entropy.

This is XLA code in the reference, not a Pallas kernel, so the port is
plain torch ops with the reference's arithmetic: f32 statistics, scores
and accumulators, casts back where the reference casts; in attention the
pad mask ``kpos < 2**29`` (padded key positions are set to 2**30),
``-inf`` masked scores with a ``-1e30`` stand-in for a row's running max
while it has seen no key, and GQA by grouping query heads.
``scaled_dot_product_attention`` is not used: its masking and rounding
are not the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def _inv_sqrt(n) -> float:
    """The reference's ``1 / f32(sqrt(n))``, divided in f32."""
    return float(torch.tensor(1.0) / torch.tensor(math.sqrt(n),
                                                  dtype=torch.float32))


def rms_norm(x, scale, eps=1e-6):
    """f32 mean of squares, ``rsqrt``, the product cast back to x's dtype,
    then times ``scale``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(x, positions, base=10000.0):
    """x: (..., S, H, dh) with dh even; positions: (..., S). Frequencies
    ``base ** (-arange/half)`` in f32; the rotated halves are concatenated
    (not interleaved) and cast back to x's dtype."""
    half = x.shape[-1] // 2
    freqs = torch.pow(base, -torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half)
    positions = torch.as_tensor(positions, device=x.device)
    ang = positions[..., None].float() * freqs            # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _attend_chunk(q, kc, vc, qpos, kpos, scale, causal, window):
    """q: (B,Sq,Hkv,G,dh); kc/vc: (B,C,Hkv,dh). Returns the chunk's
    running max, weight sum and weighted values for the online softmax."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float(), kc.float()) * scale
    dpos = qpos[:, None] - kpos[None, :]                 # (Sq, C)
    mask = (kpos[None, :] < 2 ** 29).expand(dpos.shape)  # pad validity
    if causal:
        mask = mask & (dpos >= 0)
    if window is not None:
        mask = mask & (dpos < window)
    s = torch.where(mask[None, :, None, None, :], s, -math.inf)
    m = s.amax(dim=-1)                                   # (B,Sq,Hkv,G)
    p = torch.exp(s - m[..., None])
    finite = torch.isfinite(m)
    p = torch.where(finite[..., None], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bqhgk,bkhd->bqhgd", p, vc.float())
    m = torch.where(finite, m, -1e30)
    return m, l, o


def chunked_attention(q, k, v, *, causal=True, window=None, chunk=1024,
                      q_offset=0):
    """Flash-style attention: online softmax over KV chunks, O(S·C) memory.

    q: (B, Sq, H, dh); k, v: (B, Skv, Hkv, dh) with H = Hkv * G (GQA).
    Returns (B, Sq, H, dh) in q.dtype.
    """
    b, sq, h, dh = q.shape
    _, skv, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, dh)
    scale = _inv_sqrt(dh)
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
    kp, vp = k, v
    if pad:  # (F.pad by 0 only copies)
        kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kpos_full = torch.arange(nchunks * chunk, device=dev)
    kpos_full = torch.where(kpos_full < skv, kpos_full, 2 ** 30)
    qpos = q_offset + torch.arange(sq, device=dev)
    kc = kp.reshape(b, nchunks, chunk, hkv, dh)
    vc = vp.reshape(b, nchunks, chunk, hkv, dv)
    kposc = kpos_full.reshape(nchunks, chunk)

    m = torch.full((b, sq, hkv, g), -1e30, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, hkv, g), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, hkv, g, dv), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        mi, li, oi = _attend_chunk(qg, kc[:, c], vc[:, c], qpos, kposc[c],
                                   scale, causal, window)
        m_new = torch.maximum(m, mi)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(mi - m_new)
        l = l * alpha + li * beta
        o = o * alpha[..., None] + oi * beta[..., None]
        m = m_new
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dv).to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, length=None, window=None):
    """Single-position attention against a full cache.

    q: (B, H, dh); caches: (B, S, Hkv, dh). ``length``: current cache fill
    (positions >= length masked; with ``window`` also positions below
    ``length - window``). f32 scores and softmax. Returns (B, H, dh).
    """
    b, h, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(b, hkv, h // hkv, dh)
    scores = torch.einsum("bhgd,bshd->bhgs", qg.float(),
                          k_cache.float()) * _inv_sqrt(dh)
    if length is not None:
        pos = torch.arange(s, device=q.device)
        mask = pos < length
        if window is not None:
            mask = mask & (pos >= length - window)
        scores = torch.where(mask[None, None, None, :], scores, -math.inf)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return out.reshape(b, h, -1).to(q.dtype)


def silu(x):
    """``x * sigmoid(x)`` as ``jax.nn.silu`` is written, each op rounded to
    x's dtype (``F.silu`` rounds once). In bf16 the sigmoid is XLA's
    ``1 / (1 + exp(-x))``, op by op (bit-equal to ``lax.logistic`` there;
    ``torch.sigmoid`` rounds once and differs in a third of bf16 inputs).
    """
    if x.dtype == torch.bfloat16:
        return x * (1 / (1 + torch.exp(-x)))
    return x * torch.sigmoid(x)


def mlp_swiglu(x, w1, w3, w2):
    return torch.einsum("...f,fd->...d",
                        silu(torch.einsum("...d,df->...f", x, w1))
                        * torch.einsum("...d,df->...f", x, w3), w2)


def dense_mlp(x, ws, bs=None, act=F.relu, final_act=False):
    """Plain MLP: ws list of (d_in, d_out)."""
    for i, w in enumerate(ws):
        x = x @ w
        if bs is not None:
            x = x + bs[i]
        if i < len(ws) - 1 or final_act:
            x = act(x)
    return x


def _xent_chunk(hf, wci, m, l, c0, v):
    """One vocab chunk of the running logsumexp: columns c0.. of the
    unembedding (the last chunk zero-padded to the chunk's width, its
    padded columns masked to -inf, as the reference pads)."""
    chunk = wci.shape[1]
    logits = hf @ wci.float()                              # (T, chunk)
    col = c0 + torch.arange(chunk, device=hf.device)
    logits = torch.where((col < v)[None, :], logits, -math.inf)
    m_new = torch.maximum(m, logits.amax(dim=-1))
    l_new = l * torch.exp(m - m_new) + torch.exp(
        logits - m_new[:, None]).sum(dim=-1)
    return m_new, l_new


def chunked_softmax_xent(h, unembed, labels, chunk=16384):
    """Cross entropy without materializing full (T, V) logits.

    h: (T, d); unembed: (d, V); labels: (T,). A running max and sum over
    vocab chunks, each chunk under ``torch.utils.checkpoint`` (its logits
    are recomputed in backward, the reference's ``jax.checkpoint``), so
    at most one (T, chunk) block of logits exists at a time. The target
    logit is the label's unembedding column gathered (``F.embedding``:
    its backward sums repeated labels without float atomics) and dotted
    with h in f32. Returns the mean loss.
    """
    t, d = h.shape
    v = unembed.shape[1]
    hf = h.float()
    m = torch.full((t,), -1e30, dtype=torch.float32, device=h.device)
    l = torch.zeros((t,), dtype=torch.float32, device=h.device)
    for i, wci in enumerate(unembed.split(chunk, dim=1)):
        if wci.shape[1] < chunk:
            wci = F.pad(wci, (0, chunk - wci.shape[1]))
        m, l = checkpoint(_xent_chunk, hf, wci, m, l, i * chunk, v,
                          use_reentrant=False)
    w_tgt = F.embedding(torch.as_tensor(labels, device=h.device),
                        unembed.t()).float()               # (T, d)
    tgt = (hf * w_tgt).sum(dim=-1)
    logz = m + torch.log(torch.clamp(l, min=1e-30))
    return (logz - tgt).mean()
