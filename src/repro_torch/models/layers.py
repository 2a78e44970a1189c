"""Shared neural layers (port of ``repro.models.layers``): memory-bounded
(flash-style) attention by online softmax over KV chunks.

This is XLA code in the reference, not a Pallas kernel, so the port is
plain torch ops with the reference's arithmetic: f32 scores and
accumulators, the pad mask ``kpos < 2**29`` (padded key positions are set
to 2**30), ``-inf`` masked scores with a ``-1e30`` stand-in for a row's
running max while it has seen no key, and GQA by grouping query heads.
``scaled_dot_product_attention`` is not used: its masking and rounding
are not the reference's. ``rms_norm``, ``rope``, ``decode_attention``,
``mlp_swiglu`` and ``chunked_softmax_xent`` come with the LM models.
"""
from __future__ import annotations

import math

import torch


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
    # the reference's 1 / f32(sqrt(dh)), divided in f32
    scale = float(torch.tensor(1.0) / torch.tensor(math.sqrt(dh),
                                                   dtype=torch.float32))
    nchunks = -(-skv // chunk)
    pad = nchunks * chunk - skv
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
