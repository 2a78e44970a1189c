"""Host-side BSR preparation and the wrappers over the BSR kernels (port
of the BSR half of ``repro.kernels.ops``; the segment-sum half waits for
its kernel)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.structure import BSR, Graph, to_bsr
from ..runtime import resolve_device, torch_dtype
from .bsr_spmm import BsrOperand, bsr_converge_cols, bsr_scaled_matvec


def pad_empty_rows(bsr: BSR) -> BSR:
    """Insert a zero block at (r, 0) for every empty block-row, so every
    block row owns at least one block (the reference's kernel needs it to
    write every output tile; the port keeps the same layout so plans
    carry across)."""
    present = np.zeros(bsr.n_block_rows, bool)
    present[bsr.brow] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size == 0:
        return bsr
    bs = bsr.bs
    blocks = np.concatenate([bsr.blocks,
                             np.zeros((len(missing), bs, bs), np.float32)])
    brow = np.concatenate([bsr.brow, missing])
    bcol = np.concatenate([bsr.bcol, np.zeros(len(missing), np.int32)])
    order = np.argsort(brow, kind="stable")
    counts = np.bincount(brow, minlength=bsr.n_block_rows)
    row_ptr = np.zeros(bsr.n_block_rows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return BSR(bsr.n_nodes, bs, blocks[order], brow[order].astype(np.int32),
               bcol[order].astype(np.int32), row_ptr)


def row_ptr_of(idx: np.ndarray, n_brows: int) -> np.ndarray:
    """The (n_brows + 1,) int32 CSR-over-blocks pointer of a brow-sorted
    (nblocks, 2) idx table."""
    brow = np.asarray(idx)[:, 0]
    if brow.size and (np.any(np.diff(brow) < 0) or brow[0] < 0
                      or brow[-1] >= n_brows):
        raise ValueError("idx must be sorted by block row within "
                         f"[0, {n_brows})")
    counts = np.bincount(brow, minlength=n_brows)
    row_ptr = np.zeros(n_brows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class DeviceBSR:
    """Device-resident BSR ready for K1: blocks, the brow-sorted idx table
    and its row_ptr (derived once, on the host)."""

    blocks: torch.Tensor   # (nblocks, bs, bs)
    idx: torch.Tensor      # (nblocks, 2) int32 (brow, bcol) sorted by brow
    row_ptr: torch.Tensor  # (n_pad / bs + 1,) int32
    bs: int
    n_nodes: int
    n_pad: int

    @property
    def operand(self) -> BsrOperand:
        return BsrOperand(self.blocks, self.idx, self.row_ptr)

    @staticmethod
    def from_arrays(blocks, idx, bs: int, n_nodes: int, n_pad: int,
                    device="cuda", dtype=None) -> "DeviceBSR":
        """Ship host block/idx arrays (``dtype`` None keeps the blocks'
        own dtype)."""
        dev = resolve_device(device)
        idx = np.array(idx, np.int32, order="C")  # owned, writable copies
        row_ptr = row_ptr_of(idx, n_pad // bs)
        t = torch.from_numpy(np.array(blocks, order="C"))
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return DeviceBSR(t.to(dev), torch.from_numpy(idx).to(dev),
                         torch.from_numpy(row_ptr).to(dev), int(bs),
                         int(n_nodes), int(n_pad))

    @staticmethod
    def build(g: Graph, bs: int = 128, transpose: bool = False,
              dtype="float32", values: Optional[np.ndarray] = None,
              device="cuda") -> "DeviceBSR":
        """``values`` are per-edge weights in g's edge order (default 1.0);
        ``reverse()`` preserves edge order, so they apply to either side."""
        gg = g.reverse() if transpose else g
        bsr = pad_empty_rows(to_bsr(gg, bs, values=values))
        idx = np.stack([bsr.brow, bsr.bcol], axis=1).astype(np.int32)
        return DeviceBSR.from_arrays(bsr.blocks, idx, bs, g.n_nodes,
                                     bsr.n_padded, device, dtype)

    def astype(self, dtype) -> "DeviceBSR":
        """The same layout with the blocks cast (the ladder's bulk copy)."""
        return dataclasses.replace(self,
                                   blocks=self.blocks.to(torch_dtype(dtype)))


def bsr_revalue(idx: np.ndarray, bs: int, n_pad: int, src: np.ndarray,
                dst: np.ndarray, vals: np.ndarray,
                dtype=np.float64) -> np.ndarray | None:
    """Re-scatter new edge values into an existing BSR block layout.

    ``idx`` is a DeviceBSR's (nblocks, 2) (brow, bcol) table, sorted
    lexicographically; ``src``/``dst``/``vals`` are the edges in the
    layout's own (permuted) node space. Returns the new (nblocks, bs, bs)
    host block array, or None when an edge falls in a block absent from
    the layout (the caller must then rebuild the structure).
    """
    idx = np.asarray(idx)
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    nbr = n_pad // bs
    ikey = idx[:, 0].astype(np.int64) * nbr + idx[:, 1]
    bkey = (src // bs) * nbr + (dst // bs)
    pos = np.searchsorted(ikey, bkey)
    if bkey.size and (np.any(pos >= len(ikey))
                      or np.any(ikey[np.minimum(pos, len(ikey) - 1)] != bkey)):
        return None
    blocks = np.zeros((len(ikey), bs, bs), dtype)
    np.add.at(blocks, (pos, src % bs, dst % bs), np.asarray(vals, dtype))
    return blocks


def _rows(t, n_pad: int):
    """(n, V) -> (n_pad, V), zero rows appended."""
    pad = n_pad - t.shape[0]
    return torch.nn.functional.pad(t, (0, 0, 0, pad)) if pad else t


def bsr_matvec(dbsr: DeviceBSR, x, cin=None, accum_dtype=None):
    """y = A @ (x * cin). x: (N,) | (N, V); cin: None | (N,) shared diagonal
    | (N, V) per-column diagonals; returns the shape matching x.
    ``accum_dtype`` None is the kernel's own (f64 for f64 blocks, else
    f32)."""
    squeeze = x.dim() == 1
    xv = x[:, None] if squeeze else x
    xv = _rows(xv, dbsr.n_pad).contiguous()
    if cin is None:
        cv = torch.ones((dbsr.n_pad, 1), dtype=xv.dtype, device=xv.device)
    else:
        cv = cin[:, None] if cin.dim() == 1 else cin
        cv = _rows(cv.to(xv.dtype), dbsr.n_pad).contiguous()
    y = bsr_scaled_matvec(dbsr.blocks, dbsr.idx, dbsr.row_ptr, xv, cv,
                          bs=dbsr.bs, accum_dtype=accum_dtype)
    y = y[: dbsr.n_nodes]
    return y[:, 0] if squeeze else y


def bsr_converge(lt: DeviceBSR, lfwd: DeviceBSR, h0, ca, ch, mask, tol,
                 max_iter: int, accum_dtype=None, perm=None, inv=None,
                 rank_k: int = 0, stable_sweeps: int = 2,
                 lt_lo: DeviceBSR | None = None,
                 lfwd_lo: DeviceBSR | None = None,
                 bulk_tol: float = 0.0, bulk_dtype=None):
    """Convergence loop over a DeviceBSR operator pair (``bsr_converge_cols``).

    h0/ca/ch/mask: (n, V) with n <= lt.n_pad (rows pad with zeros and slice
    back off). ``perm``/``inv`` (int64 tensors on the inputs' device):
    the node permutation (new -> old) the operators were built in and its
    inverse; inputs are gathered by ``perm`` at entry and results by
    ``inv`` at exit, on the device. The rank-stability check runs in the
    operator's (permuted) node order. ``bulk_dtype`` (a dtype name) arms
    the ladder and needs ``lt_lo``/``lfwd_lo`` and ``bulk_tol``. Returns
    (h, a, conv, res) shaped like the inputs.
    """
    if lt.bs != lfwd.bs or lt.n_pad != lfwd.n_pad:
        raise ValueError("mismatched operators")
    if bulk_dtype is not None and (lt_lo is None or lfwd_lo is None):
        raise ValueError("bulk_dtype set but lt_lo/lfwd_lo operators missing")
    n = h0.shape[0]
    args = (h0, ca, ch, mask)
    if perm is not None:
        # a mis-sized permutation would gather the wrong rows
        if perm.shape[0] != n:
            raise ValueError(f"perm has {perm.shape[0]} rows, inputs {n}")
        args = tuple(x.index_select(0, perm) for x in args)
    args = tuple(_rows(x, lt.n_pad).contiguous() for x in args)
    h, a, conv, res = bsr_converge_cols(
        lt.operand, lfwd.operand, *args, tol, bs=lt.bs,
        accum_dtype=accum_dtype, max_iter=max_iter, rank_k=int(rank_k),
        stable_sweeps=int(stable_sweeps),
        lt_lo=None if lt_lo is None else lt_lo.operand,
        lf_lo=None if lfwd_lo is None else lfwd_lo.operand,
        bulk_tol=bulk_tol, bulk_dtype=bulk_dtype)
    h, a = h[:n], a[:n]
    if inv is not None:
        if inv.shape[0] != n:
            raise ValueError(f"inv has {inv.shape[0]} rows, inputs {n}")
        h, a = h.index_select(0, inv), a.index_select(0, inv)
    return h, a, conv, res


def classify_exit(conv, res, tol: float, max_iter: int, rank_k: int = 0,
                  stable_sweeps: int = 2):
    """Per-column exit reasons from what every loop returns: ``conv``
    (sweeps used) and ``res`` (the one-extra-sweep certificate).

    * ``max_iter``    — the column spent the full budget;
    * ``rank_stable`` — rank stopping was armed and the column stopped with
      its certified residual still above ``tol``;
    * ``residual``    — the L1 residual reached ``tol``.
    """
    conv = np.asarray(conv)
    res = np.asarray(res)
    out = []
    for c, r in zip(conv.ravel(), res.ravel()):
        if int(c) >= int(max_iter):
            out.append("max_iter")
        elif rank_k > 0 and float(r) > float(tol):
            out.append("rank_stable")
        else:
            out.append("residual")
    return out
