"""Tiled segment-sum of gathered edge messages (K3).

Port of ``repro.kernels.seg_matmul``: the scatter half of message passing
(GNN aggregation, EmbeddingBag reduce, HITS edge scatter). The messages
arrive gathered per edge and laid out by ``ops.build_tiled_segments``:
tiles of ``tile_e`` slots, each tile owned by one destination block of
``bs`` rows (``blkid``, sorted), each slot carrying its row in the block
(``off``) and a 0/1 padding mask (``valid``). Within a block the slots
keep the edges' input order; they are not sorted by row.

``seg_matmul`` (replaces the Pallas kernel ``_seg_kernel``) launches
``csrc/seg_matmul.cu::seg_matmul_kernel`` for CUDA tensors and runs
``seg_matmul_plain`` for CPU tensors; on the card it launches its kernel
or raises. The kernel runs one CTA per (tile, chunk of ``SEG_FC``
columns), writes each tile's rounded contribution to a workspace, and
the last CTA of each block adds them in tile order (``Scratch``).
``counters.seg_matmul`` (``kernels.build``) counts kernel launches.

Rounding follows the Pallas kernel: each message is cast to
``accum_dtype`` (f32 by default, also for f64 messages) and multiplied by
its ``valid`` weight there; each tile's sum per row is rounded to
``accum_dtype`` (kept in f64 and rounded once, so its value does not
depend on the order of the sum), then to the messages' dtype, and added
into the row's output in that dtype, in tile order. Both versions sum a
row's slots in slot order, so they agree bit for bit in every dtype.

Finite messages only: the reference pads with ``0 * msgs[0]`` and its
one-hot product turns a non-finite ``msgs[0]`` into NaN rows where its own
oracle does not; the port skips padded slots and does not reproduce that.
A block that owns no tile comes out zero (the Pallas kernel leaves it
unwritten).
"""
from __future__ import annotations

import ctypes

import torch

from ..runtime import torch_dtype
from . import build as _build
from .build import Scratch, counters, reset_counters  # noqa: F401

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
_ACCUM_CODE = {torch.float64: 0, torch.float32: 1}
SEG_FC = 32  # widest column chunk of one K3 CTA (K3_FC)


def _declare(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.seg_matmul_launch.argtypes = [i, i, i, i, i, i, i, p, p, p, p, p, p,
                                      p, p, p]
    lib.seg_matmul_launch.restype = i


def _accum(accum_dtype) -> torch.dtype:
    acc = torch_dtype(accum_dtype)
    if acc not in _ACCUM_CODE:
        raise ValueError(f"K3 accumulates in float32 or float64, not {acc}")
    return acc


def _tile_e(blkid, msgs) -> int:
    n_tiles, e_pad = blkid.shape[0], msgs.shape[0]
    if n_tiles == 0:
        if e_pad:
            raise ValueError(f"{e_pad} message rows but no tiles")
        return 1
    if e_pad % n_tiles:
        raise ValueError(f"{e_pad} message rows do not split into "
                         f"{n_tiles} tiles")
    return e_pad // n_tiles


def seg_scratch_sizes(n_tiles: int, n_blocks: int, bs: int, f: int,
                      itemsize: int) -> tuple:
    """(workspace bytes, fold counters) of a K3 launch: every tile's
    contribution (n_tiles, bs, F) in the messages' dtype, and one counter
    per block and chunk of ``SEG_FC`` columns."""
    return n_tiles * bs * f * itemsize, n_blocks * -(-f // SEG_FC)


def seg_matmul_plain(blkid, msgs, off, valid, n_blocks: int, *,
                     bs: int = 128, accum_dtype="float32"):
    """Plain torch K3, rounded like the kernel (see the module docstring).

    blkid: (n_tiles,) int destination block per tile, non-decreasing;
    msgs: (n_tiles*tile_e, F); off/valid: (n_tiles*tile_e, 1) or
    (n_tiles*tile_e,) int. Returns (n_blocks*bs, F) in msgs' dtype.
    """
    acc = _accum(accum_dtype)
    tile_e = _tile_e(blkid, msgs)
    n_tiles = blkid.shape[0]
    e_pad, f = msgs.shape
    dev = msgs.device
    off = off.reshape(-1).long()
    w = valid.reshape(-1)
    # slot -> segment (tile, row); padded or out-of-block slots go to an
    # extra row bs per tile, dropped below
    row = torch.where((w != 0) & (off >= 0) & (off < bs), off,
                      torch.full_like(off, bs))
    seg = torch.arange(e_pad, device=dev) // tile_e * (bs + 1) + row
    order = torch.argsort(seg, stable=True)
    m = (msgs.to(acc) * w.to(acc)[:, None]).double().index_select(0, order)
    # each segment summed in slot order (segment_reduce adds in order)
    sums = torch.segment_reduce(
        m, "sum", lengths=torch.bincount(seg, minlength=n_tiles * (bs + 1)),
        axis=0)
    contrib = sums.view(n_tiles, bs + 1, f)[:, :bs].to(acc).to(msgs.dtype)
    y = torch.zeros((n_blocks, bs, f), dtype=msgs.dtype, device=dev)
    blk = blkid.long()
    if n_tiles:
        # a tile's position among its block's tiles; the running output
        # takes one tile per block per step, in tile order
        pos = torch.arange(n_tiles, device=dev) - torch.searchsorted(blk, blk)
        for t in range(int(pos.max()) + 1):
            sel = (pos == t).nonzero().squeeze(1)
            rows = blk.index_select(0, sel)
            y.index_copy_(0, rows, y.index_select(0, rows)
                          + contrib.index_select(0, sel))
    return y.reshape(n_blocks * bs, f)


def _launch(blkid, msgs, off, valid, n_blocks: int, bs: int, acc,
            tile_ptr=None, scratch=None):
    dev = msgs.device
    if msgs.dtype not in _DTYPE_CODE:
        raise ValueError(f"K3 takes f64, f32 or bf16 messages, not "
                         f"{msgs.dtype}")
    if msgs.dim() != 2 or not msgs.is_contiguous():
        raise ValueError("msgs must be a contiguous (E_pad, F) tensor")
    tile_e = _tile_e(blkid, msgs)
    e_pad, f = msgs.shape
    off, valid = off.reshape(-1), valid.reshape(-1)
    for name, t, n in (("blkid", blkid, blkid.shape[0]), ("off", off, e_pad),
                       ("valid", valid, e_pad)):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape[0] != n):
            raise ValueError(f"{name} must be a contiguous ({n},) int32 "
                             f"tensor on {dev}")
    out = torch.empty((n_blocks * bs, f), dtype=msgs.dtype, device=dev)
    if out.numel() == 0:
        return out
    # block b owns tiles tile_ptr[b]:tile_ptr[b+1] of the sorted blkid;
    # callers with a fixed layout pass it made once on the host
    if tile_ptr is None:
        tile_ptr = torch.searchsorted(
            blkid, torch.arange(n_blocks + 1, dtype=torch.int32, device=dev),
            out_int32=True)
    elif (tile_ptr.device != dev or tile_ptr.dtype != torch.int32
          or not tile_ptr.is_contiguous()
          or tuple(tile_ptr.shape) != (n_blocks + 1,)):
        raise ValueError(f"tile_ptr must be a contiguous ({n_blocks + 1},) "
                         f"int32 tensor on {dev}")
    n_tiles = blkid.shape[0]
    scratch = Scratch.on(dev, scratch).reserve(*seg_scratch_sizes(
        n_tiles, n_blocks, bs, f, msgs.element_size()))
    lib = _build.load("seg_matmul", _declare)
    err = lib.seg_matmul_launch(
        _DTYPE_CODE[msgs.dtype], _ACCUM_CODE[acc], bs, tile_e, f, n_tiles,
        n_blocks, blkid.data_ptr(), tile_ptr.data_ptr(), msgs.data_ptr(),
        off.data_ptr(), valid.data_ptr(), out.data_ptr(),
        scratch.ws.data_ptr(), scratch.cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    counters.seg_matmul += 1
    if err != 0:
        raise RuntimeError(f"seg_matmul launch failed: cudaError {err}")
    return out


def seg_matmul(blkid, msgs, off, valid, n_blocks: int, *, bs: int = 128,
               accum_dtype="float32", tile_ptr=None, scratch=None):
    """Segment-sum messages into (n_blocks*bs, F) (K3).

    blkid: (n_tiles,) int32 destination block per edge tile (sorted).
    msgs:  (n_tiles*tile_e, F) gathered messages (padded with zeros).
    off:   (n_tiles*tile_e, 1) int32 destination offset within block.
    valid: (n_tiles*tile_e, 1) 0/1 mask for padding edges.
    tile_ptr: optional (n_blocks+1,) int32 on msgs' device, block b's
        tiles at tile_ptr[b]:tile_ptr[b+1] (``ops.tile_ptr_of``); made
        from blkid on the device when absent.
    scratch: optional ``Scratch`` on msgs' device, the kernel's workspace
        and fold counters (grown as needed); a new one when None.

    CPU tensors run ``seg_matmul_plain``; CUDA tensors launch the kernel;
    ``meta`` tensors (the dry-run) give the output's shape and count the
    kernel's traffic in the active cost model: its operands read once,
    its output written once, its workspace written and read back.
    """
    acc = _accum(accum_dtype)
    if msgs.device.type == "meta":
        from ..launch.hlo_cost import count_kernel
        out = msgs.new_empty((n_blocks * bs, msgs.shape[1]))
        ws, _ = seg_scratch_sizes(blkid.shape[0], n_blocks, bs,
                                  msgs.shape[1], msgs.element_size())
        reads = (blkid, msgs, off, valid) + \
            ((tile_ptr,) if tile_ptr is not None else ())
        count_kernel(reads, (out,), flops=msgs.numel(), extra_bytes=2 * ws)
        return out
    if not msgs.is_cuda:
        return seg_matmul_plain(blkid, msgs, off, valid, n_blocks, bs=bs,
                                accum_dtype=acc)
    return _launch(blkid, msgs, off, valid, n_blocks, bs, acc, tile_ptr,
                   scratch)
