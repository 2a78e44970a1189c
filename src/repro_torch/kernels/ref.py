"""Plain-torch oracles of the kernels (port of ``repro.kernels.ref``).

Like the reference oracles they compute in f32 whatever the input dtype,
so they are f32 allclose targets, not f64 ones: each kernel's own plain
version (``bsr_spmm.bsr_scaled_matvec_plain``,
``seg_matmul.seg_matmul_plain``) copies the kernel's rounding and is the
one the f64 tests hold it to.
"""
from __future__ import annotations

import torch


def bsr_scaled_matvec_ref(blocks, idx, x, cin, n_pad: int):
    """Dense-equivalent y = A @ (x * cin), A assembled from BSR blocks."""
    bs = blocks.shape[1]
    xs = (x * cin).to(torch.float32)
    y = torch.zeros((n_pad, x.shape[1]), dtype=torch.float32,
                    device=x.device)
    for k in range(blocks.shape[0]):
        r, c = int(idx[k, 0]), int(idx[k, 1])
        y[r * bs:(r + 1) * bs] += blocks[k].to(torch.float32) @ \
            xs[c * bs:(c + 1) * bs]
    return y.to(x.dtype)


def seg_matmul_ref(blkid, msgs, off, valid, n_blocks: int, bs: int):
    """Segment-sum oracle: scatter-add each valid message to its global row
    (``index_add_``: on CUDA its float atomics add in no fixed order)."""
    n_tiles = blkid.shape[0]
    tile_e = msgs.shape[0] // n_tiles
    rows = blkid.long().repeat_interleave(tile_e) * bs + off[:, 0].long()
    m = msgs.to(torch.float32) * valid.to(torch.float32)
    out = torch.zeros((n_blocks * bs, msgs.shape[1]), dtype=torch.float32,
                      device=msgs.device)
    out.index_add_(0, rows, m)
    return out.to(msgs.dtype)
