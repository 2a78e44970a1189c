"""Host-side BSR and segment preparation and the wrappers over the
kernels (port of ``repro.kernels.ops``), with the whole-graph
accelerated-HITS sweep on K1's link form (``hits_sweep_bsr``)."""
from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..graph.structure import BSR, Graph, to_bsr
from ..runtime import from_host, resolve_device, torch_dtype
from .bsr_spmm import (KL_ROUNDS, BsrOperand, LinkOperand, bsr_converge_cols,
                       bsr_scaled_matvec, links_scaled_matvec)
from .build import Scratch
from .seg_matmul import seg_matmul


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


def _ptr_of(keys: np.ndarray, n: int, what: str) -> np.ndarray:
    """The (n + 1,) int32 pointer of sorted keys in [0, n): key k's
    entries are keys[ptr[k]:ptr[k+1]]."""
    if keys.size and (np.any(np.diff(keys) < 0) or keys[0] < 0
                      or keys[-1] >= n):
        raise ValueError(f"{what} within [0, {n})")
    ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(keys, minlength=n), out=ptr[1:])
    return ptr.astype(np.int32)


def row_ptr_of(idx: np.ndarray, n_brows: int) -> np.ndarray:
    """The (n_brows + 1,) int32 CSR-over-blocks pointer of a brow-sorted
    (nblocks, 2) idx table."""
    return _ptr_of(np.asarray(idx)[:, 0], n_brows,
                   "idx must be sorted by block row")


def tile_ptr_of(blkid: np.ndarray, n_blocks: int) -> np.ndarray:
    """K3's (n_blocks + 1,) int32 pointer over ``build_tiled_segments``'
    sorted blkid: block b owns tiles tile_ptr[b]:tile_ptr[b+1]."""
    return _ptr_of(np.asarray(blkid), n_blocks, "blkid must be sorted")


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
        own dtype; 2-byte void blocks are bf16 patterns, as
        ``runtime.host_array`` writes them)."""
        dev = resolve_device(device)
        with tracing.span("bsr.blocks"):
            idx = np.array(idx, np.int32, order="C")  # owned, writable copy
            row_ptr = row_ptr_of(idx, n_pad // bs)
        return DeviceBSR._ship(blocks, idx, row_ptr, bs, n_nodes, n_pad, dev,
                               dtype)

    @staticmethod
    def build(g: Graph, bs: int = 128, transpose: bool = False,
              dtype="float32", values: Optional[np.ndarray] = None,
              device="cuda") -> "DeviceBSR":
        """``values`` are per-edge weights in g's edge order (default 1.0);
        ``reverse()`` preserves edge order, so they apply to either side."""
        dev = resolve_device(device)
        with tracing.span("bsr.blocks"):
            gg = g.reverse() if transpose else g
            bsr = pad_empty_rows(to_bsr(gg, bs, values=values))
            idx = np.stack([bsr.brow, bsr.bcol], axis=1).astype(np.int32)
            row_ptr = row_ptr_of(idx, bsr.n_padded // bs)
        return DeviceBSR._ship(bsr.blocks, idx, row_ptr, bs, g.n_nodes,
                               bsr.n_padded, dev, dtype)

    @staticmethod
    def _ship(blocks, idx, row_ptr, bs, n_nodes, n_pad, dev,
              dtype) -> "DeviceBSR":
        """The blocks staged on the host (an owned C-ordered copy, cast to
        ``dtype``), then every array copied to ``dev``. Traced, the copy
        span waits for the copies to land."""
        with tracing.span("bsr.stage"):
            t = from_host(np.array(blocks, order="C"))
            if dtype is not None:
                t = t.to(torch_dtype(dtype))
        with tracing.span("bsr.h2d"):
            out = DeviceBSR(t.to(dev), torch.from_numpy(idx).to(dev),
                            torch.from_numpy(row_ptr).to(dev), int(bs),
                            int(n_nodes), int(n_pad))
            if dev.type == "cuda" and tracing.enabled():
                torch.cuda.synchronize(dev)
        return out

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


def bsr_matvec(dbsr: DeviceBSR, x, cin=None, accum_dtype=None,
               scratch: Optional[Scratch] = None):
    """y = A @ (x * cin). x: (N,) | (N, V); cin: None | (N,) shared diagonal
    | (N, V) per-column diagonals; returns the shape matching x.
    ``accum_dtype`` None is the kernel's own (f64 for f64 blocks, else
    f32); ``scratch`` is K1's workspace on the card (a new one when
    None)."""
    squeeze = x.dim() == 1
    xv = x[:, None] if squeeze else x
    xv = _rows(xv, dbsr.n_pad).contiguous()
    if cin is None:
        cv = torch.ones((dbsr.n_pad, 1), dtype=xv.dtype, device=xv.device)
    else:
        cv = cin[:, None] if cin.dim() == 1 else cin
        cv = _rows(cv.to(xv.dtype), dbsr.n_pad).contiguous()
    y = bsr_scaled_matvec(dbsr.blocks, dbsr.idx, dbsr.row_ptr, xv, cv,
                          bs=dbsr.bs, accum_dtype=accum_dtype,
                          scratch=scratch)
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


def bsr_nblocks(g: Graph, bs: int, transpose: bool = False) -> int:
    """Blocks of ``DeviceBSR.build(g, bs, transpose)`` (the nonzero blocks
    plus one zero block per empty block row), counted from the edges
    alone, before any block is made."""
    rows, cols = (g.dst, g.src) if transpose else (g.src, g.dst)
    nbr = (g.n_nodes + bs - 1) // bs
    keys = np.unique((rows // bs).astype(np.int64) * nbr + cols // bs)
    return len(keys) + nbr - len(np.unique(keys // nbr))


LINK_TERMS = 4  # links a lane aims at in K1's link form (rows of the mean length)


def link_lanes(lengths: np.ndarray) -> int:
    """The lanes K1's link form gives a row of an operator with these row
    lengths: the power of two (1 to 32) nearest above the mean length of
    its non-empty rows over ``LINK_TERMS``. Rows longer than ``KL_ROUNDS``
    x lanes are the kernel's long rows, a CTA each."""
    live = lengths[lengths > 0]
    want = live.mean() / LINK_TERMS if live.size else 1.0
    lanes = 1
    while lanes < 32 and lanes < want:
        lanes *= 2
    return lanes


def link_operand(g: Graph, transpose: bool = False,
                 device="cuda") -> LinkOperand:
    """K1's link form of g's 0/1 operator on ``device``: L (row i: page
    i's out-links) or, with ``transpose``, Lᵀ (row i: its in-links), in
    the graph's own node numbering; a repeated link stays two entries.
    The kernel's work split (``lanes``, the long rows) is fixed here, once,
    from the row lengths."""
    dev = resolve_device(device)
    with tracing.span("bsr.blocks"):
        rows, cols = (g.dst, g.src) if transpose else (g.src, g.dst)
        if len(rows) >= 2**31:
            raise ValueError(f"{len(rows)} links: K1's link form indexes "
                             "them with int32")
        order = np.lexsort((cols, rows))
        ptr = _ptr_of(rows[order], g.n_nodes, "links within [0, n)")
        lengths = np.diff(ptr)
        lanes = link_lanes(lengths)
        long_rows = np.nonzero(lengths > KL_ROUNDS * lanes)[0]
    with tracing.span("bsr.stage"):
        host = [torch.from_numpy(np.ascontiguousarray(a, np.int32))
                for a in (ptr, cols[order], long_rows)]
    with tracing.span("bsr.h2d"):
        out = LinkOperand(*(t.to(dev) for t in host), lanes)
        if dev.type == "cuda" and tracing.enabled():
            torch.cuda.synchronize(dev)
    return out


def hits_sweep_bsr(g: Graph, ca=None, ch=None, bs: int = 128,
                   dtype="float32", device="cuda"):
    """Accelerated-HITS sweep over the whole graph on K1's link form.

    a = Lᵀ(h ⊙ ch);  h' = L(a ⊙ ca);  h' ← h'/‖h'‖₁. Returns sweep(h)->(h',a)
    plus the two ``LinkOperand``s (Lᵀ for the authority step, L for the
    hub step). h: (N,) or (N, V); ``ca``/``ch``: None or (N,) arrays, cast and
    laid out as (N, 1) once, here. The operators are 0/1 and carry no
    values, so they are stored as their links in the graph's own node
    order (the reference's ``hits_sweep_bsr`` stores them as dense
    ``bs`` x ``bs`` blocks: britannica's Lᵀ holds 27,214 of 165 x 165,
    each ~0.5 % full), and each product is one launch of
    ``bsr_spmm.links_scaled_matvec`` over exactly N rows. ``bs`` is kept
    for the reference's signature; the link form has no blocks and does
    not read it. On the card the operators' bytes are checked against the
    card's free memory before any is built, and a graph that does not fit
    raises ``MemoryError``.
    """
    dev = resolve_device(device)
    dt = torch_dtype(dtype)
    n = g.n_nodes
    with tracing.span("ops.fit"):
        if dev.type == "cuda":
            need = 2 * 4 * (n + 1 + g.n_edges) \
                + 2 * n * torch.empty((), dtype=dt).element_size()
            free, _total = torch.cuda.mem_get_info(dev)
            if need > free:
                raise MemoryError(
                    f"hits_sweep_bsr: the two link-form operators of this "
                    f"graph (N={n}, {g.n_edges} links, {dt}) need "
                    f"{need / 2**30:.3f} GiB of device memory, "
                    f"{free / 2**30:.3f} GiB is free")
    lt = link_operand(g, transpose=True, device=dev)
    l = link_operand(g, transpose=False, device=dev)  # noqa: E741

    def diag(c):
        if c is None:
            return torch.ones((n, 1), dtype=dt, device=dev)
        return torch.as_tensor(c).to(dev, dt).reshape(n, 1).contiguous()
    ca_t, ch_t = diag(ca), diag(ch)

    def sweep(h):
        x = h[:, None] if h.dim() == 1 else h
        a = links_scaled_matvec(lt, x.contiguous(), ch_t)
        h_new = links_scaled_matvec(l, a, ca_t)
        if h.dim() == 1:
            a, h_new = a[:, 0], h_new[:, 0]
        h_new = h_new / (h_new.abs().sum(dim=0, keepdim=h.dim() > 1) + 1e-30)
        return h_new, a

    return sweep, lt, l


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


# ---------------------------------------------------------- seg_matmul path
def tiled_layout(keys: torch.Tensor, n_rows: int, bs: int = 128,
                 tile_e: int = 256) -> dict:
    """K3's tiled layout of ``keys`` (E,) in [0, n_rows), made with torch
    ops on the keys' device (``build_tiled_segments`` is its host form):
    perm (E_pad,) slot -> position in ``keys`` (-1 for padding), blkid
    (n_tiles,), off and valid (flat (E_pad,) int32), tile_ptr
    (``tile_ptr_of``), n_blocks and e_pad. One host read (the tile
    count)."""
    dev = keys.device
    keys = keys.long()
    n_blocks = (n_rows + bs - 1) // bs
    blk = keys // bs
    order = torch.argsort(blk, stable=True)
    blk_sorted = blk.index_select(0, order)
    counts = torch.bincount(blk, minlength=n_blocks)
    tiles = torch.clamp((counts + tile_e - 1) // tile_e, min=1)
    tile_ptr = torch.zeros(n_blocks + 1, dtype=torch.long, device=dev)
    torch.cumsum(tiles, 0, out=tile_ptr[1:])
    edge_ptr = torch.cumsum(counts, 0) - counts
    n_tiles = int(tile_ptr[-1])
    e_pad = n_tiles * tile_e
    rank = torch.arange(keys.shape[0], device=dev) \
        - edge_ptr.index_select(0, blk_sorted)
    slot = tile_ptr.index_select(0, blk_sorted) * tile_e + rank
    perm = torch.full((e_pad,), -1, dtype=torch.long, device=dev)
    perm[slot] = order
    off = torch.zeros(e_pad, dtype=torch.int32, device=dev)
    off[slot] = (keys.index_select(0, order) - blk_sorted * bs).int()
    valid = torch.zeros(e_pad, dtype=torch.int32, device=dev)
    valid[slot] = 1
    blkid = torch.repeat_interleave(
        torch.arange(n_blocks, dtype=torch.int32, device=dev), tiles,
        output_size=n_tiles)
    return {"perm": perm, "blkid": blkid, "off": off, "valid": valid,
            "tile_ptr": tile_ptr.int(), "n_blocks": n_blocks, "e_pad": e_pad}


def build_tiled_segments(dst: np.ndarray, n_nodes: int, bs: int = 128,
                         tile_e: int = 256):
    """Group edges by destination block and pad each block's edge run to
    whole tiles (every block gets at least one tile). Within a block the
    edges keep their input order. Returns {perm (E_pad,) slot -> edge (-1:
    padding), blkid (n_tiles,), off (E_pad,1), valid (E_pad,1), n_blocks,
    e_pad} as host arrays (``tiled_layout`` on the host); messages are
    laid out with ``pad_messages``."""
    seg = tiled_layout(torch.from_numpy(np.array(dst, np.int64)), n_nodes,
                       bs, tile_e)
    return {"perm": seg["perm"].numpy(), "blkid": seg["blkid"].numpy(),
            "off": seg["off"].numpy()[:, None],
            "valid": seg["valid"].numpy()[:, None],
            "n_blocks": seg["n_blocks"], "e_pad": seg["e_pad"]}


@dataclasses.dataclass(frozen=True)
class DeviceSegments:
    """A ``build_tiled_segments`` layout on one device, as K3 and
    ``pad_messages`` read it: the gather (perm, padding slots at 0), blkid,
    off, valid and tile_ptr (made once on the host), plus the kernel's
    ``Scratch``. ``of`` keeps one per layout and device, so a
    message-passing loop ships its index arrays once, as ``DeviceBSR``
    does for K1."""

    gather: torch.Tensor    # (E_pad,) int64 slot -> edge, 0 for padding
    blkid: torch.Tensor     # (n_tiles,) int32
    off: torch.Tensor       # (E_pad, 1) int32
    valid: torch.Tensor     # (E_pad, 1) int32
    tile_ptr: torch.Tensor  # (n_blocks + 1,) int32
    n_blocks: int
    scratch: Scratch

    @staticmethod
    def of(seg: dict, device) -> "DeviceSegments":
        """The cached device copy of ``seg`` (keyed by its ``perm`` array,
        dropped when that array is)."""
        dev = torch.device(device)
        key = id(seg["perm"])
        ref, per_dev = _SEG_CACHE.get(key, (None, None))
        if ref is None or ref() is not seg["perm"]:
            per_dev = {}
            _SEG_CACHE[key] = (weakref.ref(seg["perm"],
                                           lambda _r: _SEG_CACHE.pop(key, None)),
                               per_dev)
        ds = per_dev.get(dev)
        if ds is None:
            as_dev = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
                a, np.int32)).to(dev)
            ds = DeviceSegments(
                torch.from_numpy(np.maximum(seg["perm"], 0)).to(dev),
                as_dev(seg["blkid"]), as_dev(seg["off"]),
                as_dev(seg["valid"]),
                as_dev(tile_ptr_of(seg["blkid"], seg["n_blocks"])),
                int(seg["n_blocks"]), Scratch(dev))
            per_dev[dev] = ds
        return ds


# id(seg["perm"]) -> (weak reference to that array, {device: DeviceSegments})
_SEG_CACHE: dict = {}


def pad_messages(msgs, seg):
    """Arrange per-edge messages (E, F) into the padded tile layout
    (E_pad, F), on the messages' device; padded slots are zero."""
    ds = DeviceSegments.of(seg, msgs.device)
    return msgs.index_select(0, ds.gather) * ds.valid


def seg_aggregate(msgs, seg, *, bs: int = 128, n_nodes: int):
    """Full segment-sum: messages (E, F) -> node aggregates (n_nodes, F),
    through K3 (``seg_matmul``) on the messages' device; the layout's
    device arrays and K3's workspace are made at its first call there."""
    m = pad_messages(msgs, seg)
    ds = DeviceSegments.of(seg, msgs.device)
    y = seg_matmul(ds.blkid, m.contiguous(), ds.off, ds.valid, ds.n_blocks,
                   bs=bs, tile_ptr=ds.tile_ptr, scratch=ds.scratch)
    return y[:n_nodes]


# ----------------------------------------------- GNN aggregation on K3
GNN_TILE_E = 256  # slots per K3 tile of the GNN's layouts


def _accum_of(dtype) -> str:
    """K3's accumulator for messages of ``dtype``: f64 for f64 (what
    ``segment_sum`` adds f64 messages in), else f32."""
    return "float64" if dtype == torch.float64 else "float32"


@dataclasses.dataclass(frozen=True)
class SlotLayout:
    """One direction of an edge set in K3's tiled layout: slot s gathers
    row ``rows[s]`` of its input and holds edge ``edge[s]`` (both 0 for
    padding slots, which K3 skips), summed into output row ``off[s]`` of
    block ``blkid`` of its tile."""

    rows: torch.Tensor      # (E_pad,) int32
    edge: torch.Tensor      # (E_pad,) int32
    blkid: torch.Tensor     # (n_tiles,) int32
    off: torch.Tensor       # (E_pad,) int32
    valid: torch.Tensor     # (E_pad,) int32
    tile_ptr: torch.Tensor  # (n_blocks + 1,) int32
    n_blocks: int
    n_out: int
    bs: int

    def messages(self, x, w=None):
        """(E_pad, F): x's rows gathered straight into the slots, times
        the slot's edge weight (``w`` (E,) per edge, None for 1)."""
        m = x.index_select(0, self.rows)
        if w is not None:
            m.mul_(w.to(m.dtype).index_select(0, self.edge)[:, None])
        return m

    def sum(self, x, w=None, scratch: Optional[Scratch] = None):
        """(n_out, F): each output row's sum of its slots' messages (K3
        on x's device)."""
        y = seg_matmul(self.blkid, self.messages(x, w), self.off,
                       self.valid, self.n_blocks, bs=self.bs,
                       accum_dtype=_accum_of(x.dtype),
                       tile_ptr=self.tile_ptr, scratch=scratch)
        return y[:self.n_out]


@dataclasses.dataclass(frozen=True)
class EdgeLayouts:
    """An edge set's two K3 layouts: ``fwd`` keyed by dst, gathering
    ``src`` (out[i] = Σ_{dst_e = i} w_e · h[src_e]), and ``rev`` keyed by
    src, gathering ``dst`` (its transpose, the gradient with respect to
    h). Edges whose src or dst lies outside [0, n) are dropped first, as
    ``jax.ops.segment_sum`` drops out-of-range destinations. One
    ``Scratch`` serves both on the card (their launches share a stream).
    """

    fwd: SlotLayout
    rev: SlotLayout
    n_nodes: int
    scratch: Optional[Scratch]
    # the dry-run's edges sharded over a device mesh: (mesh, the edges'
    # placements, whether they are (G, E) per-graph edges); the layouts
    # are then one device's, of its own edges
    sharding: Optional[tuple] = None

    @staticmethod
    def build(src, dst, n: int, bs: int = 128,
              tile_e: int = GNN_TILE_E) -> "EdgeLayouts":
        """Layouts of ``src``/``dst`` (E,) on a graph of n nodes, or of G
        graphs of n nodes each ((G, E) tensors, node ids local to their
        graph): then graph g's nodes are rows g·n..g·n + n - 1 of one
        flattened edge set, and edge weights are given flattened (G·E,).
        ``meta`` edges (the dry-run) get layouts of K3's largest size for
        their count (``_bound``); a ``DTensor``'s, its local shard's."""
        from ..models.sharding import is_dtensor
        if is_dtensor(src):
            lay = EdgeLayouts.build(src.to_local(), dst.to_local(), n, bs,
                                    tile_e)
            return dataclasses.replace(lay, sharding=(
                src.device_mesh, tuple(src.placements), src.dim() == 2))
        if src.device.type == "meta":
            return EdgeLayouts._bound(src, n, bs, tile_e)
        src, dst = torch.as_tensor(src), torch.as_tensor(dst)
        dev = src.device
        src, dst = src.long(), dst.long().to(dev)
        keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
        n_total = n
        if src.dim() == 2:
            base = torch.arange(src.shape[0], device=dev)[:, None] * n
            src, dst, n_total = src + base, dst + base, n * src.shape[0]
        src, dst, keep = src.reshape(-1), dst.reshape(-1), keep.reshape(-1)
        kept = keep.nonzero().squeeze(1)
        pad = torch.zeros(1, dtype=torch.long, device=dev)
        edge_ext = torch.cat([kept, pad])

        def side(keys, other):
            seg = tiled_layout(keys.index_select(0, kept), n_total, bs,
                               tile_e)
            pos = torch.where(seg["perm"] >= 0, seg["perm"], kept.shape[0])
            edge = edge_ext.index_select(0, pos)
            rows = torch.cat([other.index_select(0, kept), pad]) \
                .index_select(0, pos)
            return SlotLayout(rows.int(), edge.int(), seg["blkid"],
                              seg["off"], seg["valid"], seg["tile_ptr"],
                              seg["n_blocks"], n_total, bs)

        return EdgeLayouts(side(dst, src), side(src, dst), n_total,
                           Scratch(dev) if dev.type == "cuda" else None)

    @staticmethod
    def _bound(src, n: int, bs: int, tile_e: int) -> "EdgeLayouts":
        """``meta`` layouts at the most slots E edges can take: every
        block's run padded to whole tiles, at least one a block, so
        n_tiles <= n_blocks + ceil(E / tile_e)."""
        n_total = n * (src.shape[0] if src.dim() == 2 else 1)
        n_blocks = -(-n_total // bs)
        n_tiles = n_blocks + -(-src.numel() // tile_e)

        def m(k):
            return torch.empty(k, dtype=torch.int32, device="meta")

        def side():
            e_pad = n_tiles * tile_e
            return SlotLayout(m(e_pad), m(e_pad), m(n_tiles), m(e_pad),
                              m(e_pad), m(n_blocks + 1), n_blocks, n_total,
                              bs)
        return EdgeLayouts(side(), side(), n_total, None)

    @staticmethod
    def of(src, dst, n: int, bs: int = 128,
           tile_e: int = GNN_TILE_E) -> "EdgeLayouts":
        """The cached layouts of ``src``/``dst`` (keyed by the identity
        of the two tensors, dropped with either): a training loop over one
        edge set builds them once. Edge tensors must not change in place
        while cached."""
        if not (torch.is_tensor(src) and torch.is_tensor(dst)):
            return EdgeLayouts.build(src, dst, n, bs, tile_e)
        key = (id(src), id(dst), int(n), bs, tile_e)
        hit = _EDGE_CACHE.get(key)
        if hit is not None and hit[0]() is src and hit[1]() is dst:
            return hit[2]
        drop = lambda _r: _EDGE_CACHE.pop(key, None)  # noqa: E731
        lay = EdgeLayouts.build(src, dst, n, bs, tile_e)
        _EDGE_CACHE[key] = (weakref.ref(src, drop), weakref.ref(dst, drop),
                            lay)
        return lay


# (id(src), id(dst), n, bs, tile_e) -> (weak refs to src and dst, layouts)
_EDGE_CACHE: dict = {}


class _Aggregate(torch.autograd.Function):
    """out = fwd-layout sum of w·h[src]; its gradient the rev-layout sum
    of w·grad[dst]: two K3 launches, no ``index_select`` backward (an
    ``index_add_`` with float atomics on the card). No gradient flows to
    the edge weights."""

    @staticmethod
    def forward(ctx, h, lay, w):
        ctx.lay = lay
        ctx.save_for_backward(w)
        return lay.fwd.sum(h, w, lay.scratch)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        (w,) = ctx.saved_tensors
        return ctx.lay.rev.sum(grad, w, ctx.lay.scratch), None, None


def _sharded_places(lay: EdgeLayouts):
    """(h's placements for the sum, the output's): per-graph edges sum
    graph-major rows sharded as the graphs are, into the same rows;
    edges of one graph sum the whole of h into every node, a partial
    sum on each mesh dim the edges are sharded on."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, epl, per_graph = lay.sharding
    if per_graph:
        want = [Shard(0) if p.is_shard(0) else Replicate() for p in epl]
        return want, want
    return [Replicate()] * mesh.ndim, \
        [Partial() if p.is_shard() else Replicate() for p in epl]


class _ShardedAggregate(torch.autograd.Function):
    """``aggregate`` over the dry-run's sharded edges (``DTensor``s):
    each device runs its own edges' layouts on its local rows; h and the
    gradient are first redistributed to the placements the sum needs
    (``shard_like``, an explicit redistribution)."""

    @staticmethod
    def forward(ctx, h, lay, w):
        from torch.distributed.tensor import DTensor

        from ..models.sharding import shard_like
        want, out_pl = _sharded_places(lay)
        ctx.lay, ctx.h_pl, ctx.w = lay, tuple(h.placements), w
        hl = shard_like(h, _Placed(want)).to_local()
        out = lay.fwd.sum(hl, _local(w))
        return DTensor.from_local(out, lay.sharding[0],
                                  out_pl, run_check=False, shape=h.shape,
                                  stride=h.stride())

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        from torch.distributed.tensor import DTensor

        from ..models.sharding import shard_like
        lay, w = ctx.lay, ctx.w
        want, out_pl = _sharded_places(lay)
        gl = shard_like(grad, _Placed(want)).to_local()
        g = DTensor.from_local(lay.rev.sum(gl, _local(w)), lay.sharding[0],
                               out_pl,
                               run_check=False, shape=grad.shape,
                               stride=grad.stride())
        return shard_like(g, _Placed(ctx.h_pl)), None, None


@dataclasses.dataclass(frozen=True)
class _Placed:
    placements: tuple


def _local(x):
    return x.to_local() if hasattr(x, "to_local") else x


def aggregate(h, lay: EdgeLayouts, edge_w=None):
    """GIN's sum aggregation Σ_{e: dst_e = i} w_e · h[src_e] for every
    node i of ``lay`` (``EdgeLayouts.of(src, dst, n)``), with its
    gradient with respect to ``h``. ``edge_w``: None or (E,) weights (a
    bool mask included) in the edges' order. On the card both directions
    launch K3; on the CPU they run its plain version through the same
    layouts; on ``meta`` tensors (the dry-run) K3 counts its traffic."""
    w = None if edge_w is None else edge_w.detach().reshape(-1)
    if lay.sharding is not None:
        return _ShardedAggregate.apply(h, lay, w)
    if h.shape[0] != lay.n_nodes:
        raise ValueError(f"h has {h.shape[0]} rows, the layouts "
                         f"{lay.n_nodes}")
    return _Aggregate.apply(h, lay, w)
