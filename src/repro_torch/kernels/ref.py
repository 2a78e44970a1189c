"""Plain-torch oracle of the BSR product (port of ``repro.kernels.ref``).

Like the reference oracle it computes in f32 whatever the input dtype, so
it is an f32 allclose target, not an f64 one: the kernel's own plain
version (``bsr_spmm.bsr_scaled_matvec_plain``) copies the kernel's
rounding and is the one the f64 tests hold it to.
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
