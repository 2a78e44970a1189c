"""int8 error-feedback gradient compression for DP all-reduce (port of
``repro.train.compression``).

1-bit/8-bit SGD-style EF: quantize (grad + residual) to int8 with a
per-leaf scale, carry the quantization error to the next step. At 1000+
node scale this cuts DP all-reduce bytes 4x (fp32→int8); error feedback
keeps convergence. ``ef_compressed_psum`` runs over the port's
``sparse.dist.Mesh`` and takes per-shard lists, as the rest of
``sparse/dist.py`` does.
"""
from __future__ import annotations

import torch

from ..sparse import dist
from ..tree import leaves, tree_map, unflatten


def init_error_state(params):
    tree = params.to_tree() if hasattr(params, "to_tree") else params
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def _quantize(g_corr, scale):
    return torch.clamp(torch.round(g_corr / scale), -127, 127) \
        .to(torch.int8)


def compress_leaf(g, err):
    g_corr = g.float() + err
    scale = g_corr.abs().max() / 127.0 + 1e-30
    q = _quantize(g_corr, scale)
    deq = q.float() * scale
    return q, scale, g_corr - deq


def decompress_leaf(q, scale):
    return q.float() * scale


def compress_grads(grads, err_state):
    """Returns ((tree of int8 q, tree of scales), new error state)."""
    out = [compress_leaf(g, e) for g, e in zip(leaves(grads),
                                               leaves(err_state))]
    return ((unflatten(grads, [o[0] for o in out]),
             unflatten(grads, [o[1] for o in out])),
            unflatten(grads, [o[2] for o in out]))


def decompress_grads(compressed):
    qs, scales = compressed
    return tree_map(decompress_leaf, qs, scales)


def ef_compressed_psum(mesh: dist.Mesh, grads, err_state):
    """DP all-reduce over int8 grads with error feedback. ``grads`` and
    ``err_state`` are per-shard lists of trees (shard s's at index s);
    returns per-shard lists of (mean gradient tree, new error tree).

    The int8 sum accumulates in int32 (exact); the scale is the max over
    shards (``pmax``) so every shard dequantizes identically."""
    n = mesh.size
    flat_g = [leaves(t) for t in grads]
    flat_e = [leaves(t) for t in err_state]
    outs = [[] for _ in range(n)]
    errs = [[] for _ in range(n)]
    for li in range(len(flat_g[0])):
        g_corr = [flat_g[s][li].float() + flat_e[s][li] for s in range(n)]
        top = dist.pmax(mesh, [g.abs().max() for g in g_corr])
        scales = [t / 127.0 + 1e-30 for t in top]
        qs = [_quantize(g, sc) for g, sc in zip(g_corr, scales)]
        total = dist.psum(mesh, [q.to(torch.int32) for q in qs])
        for s in range(n):
            errs[s].append(g_corr[s] - qs[s].float() * scales[s])
            outs[s].append(total[s].float() * scales[s] / n)
    return ([unflatten(grads[s], outs[s]) for s in range(n)],
            [unflatten(grads[s], errs[s]) for s in range(n)])
