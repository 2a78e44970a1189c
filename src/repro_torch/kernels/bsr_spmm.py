"""Block-sparse (BSR) matrix x multi-vector with fused diagonal scaling,
and the accelerated-HITS convergence loop around it.

Port of ``repro.kernels.bsr_spmm``. Three wrappers, each with a plain
PyTorch version of the same signature beside it:

* ``bsr_scaled_matvec`` (K1, replaces the Pallas kernel ``_bsr_kernel``):
  y = (A_bsr @ (x ⊙ cin)) ⊙ mask, launched as the CUDA kernel
  ``csrc/bsr_spmm.cu::bsr_spmm_kernel``: one CTA per (block, slice of
  ``K1_ROWS`` rows) writes the block's rounded product to a workspace, and
  the last CTA of each block row adds them in idx order (``Scratch``).
* ``links_scaled_matvec`` (K1's link form, on the whole-crawl sweep
  ``ops.hits_sweep_bsr`` in ``_bsr_kernel``'s place): y = A @ (x ⊙ cin)
  for a 0/1 operator A stored as its links (``LinkOperand``), launched as
  ``csrc/bsr_spmm.cu::links_spmm_kernel``: a row's links summed in f64 by
  a fixed number of lanes, hubs by a CTA each; no workspace.
* ``sweep_epilogue`` / ``sweep_certificate``: the per-sweep epilogue of the
  loop (normalize, residual, rank stability, conv, stop flag) and the
  final certificate, as two kernels that each run one CTA per slice of
  rows (``csrc/bsr_spmm.cu::ep_slice_kernel``, ``ep_finish_kernel``).
* ``bsr_converge_cols`` (K2, replaces the Pallas loop
  ``bsr_converge_cols``): the masked multi-column loop, with the
  precision ladder and the residual certificate. On the card each call
  builds the whole loop as one CUDA graph (``K2Graph``) whose sweeps run
  under conditional WHILE nodes, the counterpart of the reference's
  ``lax.while_loop``, launches it once, reads it once and destroys it.
  ``k2_steps`` describes the graph; ``k2_rehearse`` runs that description
  with the plain versions on the CPU.

``PowerGraph`` is ``core.power.power_method_jit``'s loop on the card: a
WHILE node over a caller-captured chunk of sweeps and a residual kernel
(``csrc/bsr_spmm.cu::pm_graph_build``), the same conditional-node design.

A wrapper runs its plain version only when it is given CPU tensors; for
CUDA tensors it launches its kernel or raises. The kernels build at first
use (``kernels.build``), which also holds ``counters``: one object, shared
with K3, that counts launches per wrapper, the loop's host reads and K2's
graph builds; ``reset_counters()`` zeroes them. Inside K2's graph, K1 and
the epilogue count their own launches on the device.

Rounding copies the Pallas kernel, not the f32 oracle (``kernels.ref``):
x ⊙ cin in x's dtype, block products accumulated in f64 for f64 blocks
and f32 otherwise, each block's product rounded to y's dtype and summed
over a block row in y's dtype, in idx order. Where the reference
accumulates in f32 (block products, the epilogue's L1 sums of bf16/f32
vectors), the kernels keep the sum in f64 and round it to f32 once, so
its value does not depend on the order of the sum and the plain versions
here compute the same bits as the kernels.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import NamedTuple, Optional

import torch

from .. import tracing
from ..runtime import tol_in, torch_dtype
from . import build as _build
from .build import Scratch, counters, reset_counters  # noqa: F401

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
BLOCK_SIZES = (16, 32, 64, 128)
V_GROUP = 16   # widest column group one K1 launch takes
K1_ROWS = 32   # rows of a block one K1 CTA takes (bs 16: all 16)
KL_THREADS = 256  # threads of a CTA of K1's link form (a long row's lanes)
KL_ROUNDS = 32    # links a lane of K1's link form takes at most (long rows aside)
EP_SLICES = 128  # slices (CTAs) the epilogue kernels aim for
EP_MAXV = 256    # columns the epilogue kernels take
_EPS = 1e-30


class BsrOperand(NamedTuple):
    """The three tensors K1 reads of one BSR operator: blocks
    (nblocks, bs, bs), idx (nblocks, 2) int32 (brow, bcol) sorted by brow,
    and row_ptr (n_brows + 1,) int32 (block row r owns blocks
    row_ptr[r]:row_ptr[r+1])."""

    blocks: torch.Tensor
    idx: torch.Tensor
    row_ptr: torch.Tensor

    @property
    def nbytes(self) -> int:
        """Bytes of the operator K1 reads on each launch."""
        return sum(t.numel() * t.element_size() for t in self)


def natural_accum(dtype) -> torch.dtype:
    """The kernel's accumulator for a block dtype: f64 for f64, else f32."""
    return torch.float64 if torch_dtype(dtype) == torch.float64 \
        else torch.float32


def _declare(lib):
    p, i, d, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
        ctypes.c_longlong
    lib.bsr_spmm_launch.argtypes = [i, i, i, p, p, p, i, i, p, p, i, p, p, i,
                                    i, i, p, p, p, p]
    lib.bsr_spmm_launch.restype = i
    lib.links_spmm_launch.argtypes = [i, p, p, p, i, i, i, p, p, i, p, i, p]
    lib.links_spmm_launch.restype = i
    lib.sweep_epilogue_launch.argtypes = [i, p, p, p] + [i] * 6 + [d, ll, ll] \
        + [p] * 11
    lib.sweep_epilogue_launch.restype = i
    lib.k2_args_size.argtypes = []
    lib.k2_args_size.restype = ll
    if lib.k2_args_size() != ctypes.sizeof(_K2Args):
        raise RuntimeError(f"K2Args is {lib.k2_args_size()} bytes in the "
                           f"library, {ctypes.sizeof(_K2Args)} in _K2Args")
    lib.k2_graph_build.argtypes = [p, p]
    lib.k2_graph_build.restype = i
    lib.k2_graph_launch.argtypes = [p, p]
    lib.k2_graph_launch.restype = i
    lib.k2_graph_destroy.argtypes = [p]
    lib.k2_graph_destroy.restype = i
    lib.pm_graph_build.argtypes = [p, i, p, p, ll, i, p, p, ll, ll, d, p]
    lib.pm_graph_build.restype = i


def _lib():
    return _build.load("bsr_spmm", _declare)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check(ok: bool, msg: str):
    if not ok:
        raise ValueError(msg)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


# ------------------------------------------------------------------- K1


def bsr_scaled_matvec_plain(blocks, idx, row_ptr, x, cin, *, bs: int,
                            accum_dtype=None, mask=None):
    """Plain torch K1: y = (A @ (x ⊙ cin)) ⊙ mask, rounded like the kernel.

    x: (n_pad, V); cin: (n_pad, 1) or (n_pad, V); mask: None or (n_pad, V);
    ``accum_dtype`` None picks ``natural_accum(blocks.dtype)``.
    """
    acc = natural_accum(blocks.dtype) if accum_dtype is None \
        else torch_dtype(accum_dtype)
    n_pad, v = x.shape
    xs = (x * cin.to(x.dtype)).to(acc)
    xb = xs.view(n_pad // bs, bs, v).index_select(0, idx[:, 1].long())
    # the accumulator's value: the f64 product of the acc-typed operands,
    # rounded to acc, then to y's dtype
    contrib = torch.bmm(blocks.to(acc).double(), xb.double()).to(acc)
    y = _row_sums(contrib.to(x.dtype), idx, row_ptr).reshape(n_pad, v)
    return y if mask is None else y * mask.to(x.dtype)


def _row_sums(contrib, idx, row_ptr):
    """Per block row, the sum of its blocks' products in idx order, added
    one at a time in their dtype (the Pallas kernel's
    ``y_ref[...] += dot(...).astype(y.dtype)``)."""
    brow = idx[:, 0].long()
    starts = row_ptr[:-1].long()
    pos = torch.arange(brow.numel(), device=brow.device) - starts[brow]
    y = torch.zeros((starts.numel(),) + contrib.shape[1:],
                    dtype=contrib.dtype, device=contrib.device)
    n_steps = int((row_ptr[1:] - row_ptr[:-1]).max()) if starts.numel() else 0
    for t in range(n_steps):
        sel = (pos == t).nonzero().squeeze(1)
        rows = brow.index_select(0, sel)
        y.index_copy_(0, rows, y.index_select(0, rows)
                      + contrib.index_select(0, sel))
    return y


def _l1(x):
    """Column L1 norms (keepdim) as the kernels round them: summed in f64,
    rounded through the accumulator type (f32 for bf16, as ``jnp.sum``
    accumulates it) to x's dtype."""
    return x.abs().sum(dim=0, keepdim=True, dtype=torch.float64).to(
        natural_accum(x.dtype)).to(x.dtype)


def _vt(v: int) -> int:
    """The kernel's column width for v columns: v rounded up to a power of
    two, at most ``V_GROUP``."""
    return 1 << (min(v, V_GROUP) - 1).bit_length()


def k1_scratch_sizes(nblocks: int, n_brows: int, bs: int, v: int,
                     itemsize: int) -> tuple:
    """(workspace bytes, fold counters) of a K1 launch: every block's
    product (nblocks, vt, bs) in y's dtype, and one counter per block row
    and slice of ``K1_ROWS`` rows."""
    return (nblocks * bs * _vt(v) * itemsize,
            n_brows * (bs // min(bs, K1_ROWS)))


def _reserve_k1(scratch: Scratch, ops, bs: int, v: int) -> Scratch:
    sizes = [k1_scratch_sizes(o.blocks.shape[0], o.row_ptr.shape[0] - 1, bs,
                              v, o.blocks.element_size()) for o in ops]
    return scratch.reserve(max(w for w, _ in sizes), max(c for _, c in sizes))


def _check_operand(op: BsrOperand, bs: int, n_pad: int, dt, dev, what):
    blocks, idx, row_ptr = op
    nblocks = blocks.shape[0]
    _check(bs in BLOCK_SIZES, f"K1 block size {bs} not in {BLOCK_SIZES}")
    _check(n_pad == (row_ptr.shape[0] - 1) * bs,
           f"{what}: x has {n_pad} rows, operator {row_ptr.shape[0] - 1}x{bs}")
    _check(tuple(blocks.shape) == (nblocks, bs, bs) and tuple(idx.shape)
           == (nblocks, 2), f"{what}: blocks/idx shapes do not match")
    _check(blocks.device == dev and blocks.dtype == dt
           and blocks.is_contiguous(),
           f"{what}: blocks must be contiguous {dt} on {dev}")
    for name, t in (("idx", idx), ("row_ptr", row_ptr)):
        _check(t.device == dev and t.dtype == torch.int32
               and t.is_contiguous(), f"{what}: {name} must be contiguous "
               f"int32 on {dev}")


def _launch_spmm(op: BsrOperand, x, cin, bs: int, accum_dtype, mask, out,
                 active=None, scratch: Optional[Scratch] = None):
    """Validate and launch K1 into ``out``; V wider than ``V_GROUP`` runs as
    column groups, one launch each, one after another on one ``scratch``
    (made here when None)."""
    blocks, idx, row_ptr = op
    dev = x.device
    dt = x.dtype
    _check(dt in _DTYPE_CODE, f"K1 takes f64, f32 or bf16, not {dt}")
    acc = natural_accum(dt) if accum_dtype is None else torch_dtype(accum_dtype)
    _check(acc == natural_accum(dt),
           f"K1 accumulates {dt} in {natural_accum(dt)}, not {acc}")
    n_pad, v = x.shape
    _check_operand(op, bs, n_pad, dt, dev, "K1")
    nblocks = blocks.shape[0]
    n_brows = row_ptr.shape[0] - 1
    _check(cin.shape[0] == n_pad and cin.shape[1] in (1, v),
           f"cin must be ({n_pad}, 1) or ({n_pad}, {v})")
    for name, t in (("x", x), ("cin", cin), ("mask", mask), ("out", out)):
        if t is None:
            continue
        _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _check(t.dtype == dt, f"{name} is {t.dtype}, x is {dt}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for t in (mask, out):
        _check(t is None or tuple(t.shape) == (n_pad, v),
               f"mask/out must be ({n_pad}, {v})")
    scratch = _reserve_k1(Scratch.on(dev, scratch), [op], bs, v)
    lib = _lib()
    stream = _stream(dev)
    op_bytes = op.nbytes
    for col0 in range(0, v, V_GROUP):
        vg = min(V_GROUP, v - col0)
        err = lib.bsr_spmm_launch(
            _DTYPE_CODE[dt], bs, _vt(vg), blocks.data_ptr(), idx.data_ptr(),
            row_ptr.data_ptr(), nblocks, n_brows, x.data_ptr(),
            cin.data_ptr(), cin.shape[1], _ptr(mask), out.data_ptr(), v,
            col0, vg, scratch.ws.data_ptr(), scratch.cnt.data_ptr(),
            _ptr(active), stream)
        counters.bsr_spmm += 1
        counters.bsr_spmm_bytes += op_bytes
        _raise_on(err, "bsr_spmm")
    return out


def bsr_scaled_matvec(blocks, idx, row_ptr, x, cin, *, bs: int,
                      accum_dtype=None, mask=None,
                      scratch: Optional[Scratch] = None):
    """y = (A_bsr @ (x ⊙ cin)) ⊙ mask over the nonzero blocks (K1).

    blocks: (nblocks, bs, bs); idx: (nblocks, 2) int32 (brow, bcol) sorted
    by brow; row_ptr: (n_pad/bs + 1,) int32; x: (n_pad, V); cin: (n_pad, 1)
    shared diagonal or (n_pad, V) per-column diagonals; mask: None or
    (n_pad, V). Returns (n_pad, V) in x's dtype. CPU tensors run
    ``bsr_scaled_matvec_plain``; CUDA tensors launch the kernel, with
    ``scratch`` (a ``Scratch`` on x's device, grown as needed) as its
    workspace, or a new one when None.
    """
    with tracing.span("k1"):
        if not x.is_cuda:
            return bsr_scaled_matvec_plain(blocks, idx, row_ptr, x, cin,
                                           bs=bs, accum_dtype=accum_dtype,
                                           mask=mask)
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        return _launch_spmm(BsrOperand(blocks, idx, row_ptr), x, cin, bs,
                            accum_dtype, mask, out, scratch=scratch)


# ----------------------------------------------------------- K1, link form


class LinkOperand(NamedTuple):
    """K1's link form of an n-row 0/1 operator: ``ptr`` (n + 1,) int32
    (row i owns links ptr[i]:ptr[i+1]), ``cols`` one int32 column a link,
    sorted by row and by column within a row, ``long_rows`` (int32) the
    rows of more than ``KL_ROUNDS`` x ``lanes`` links, which the kernel
    gives a CTA each, and ``lanes`` (1 to 32, a power of two), the lanes
    every other row gets (``ops.link_operand`` fixes both from the row
    lengths)."""

    ptr: torch.Tensor
    cols: torch.Tensor
    long_rows: torch.Tensor
    lanes: int

    @property
    def nbytes(self) -> int:
        """Bytes of the operator the kernel reads on each launch."""
        return sum(t.numel() * t.element_size()
                   for t in (self.ptr, self.cols, self.long_rows))


def links_scaled_matvec_plain(op: LinkOperand, x, cin):
    """Plain torch link form: y[i] = Σ over row i's links j of x[j] ⊙ cin[j],
    each term rounded to x's dtype, summed in f64 in the kernel's order and
    rounded once, so the two agree bit for bit. x: (n, V); cin: (n, 1) or
    (n, V).

    The kernel's order: a row of w lanes (``op.lanes``, or ``KL_THREADS``
    for a long row) gives lane l its links l, l + w, ... added one by one
    from 0; the lanes are added by an xor butterfly (offsets w/2 .. 1), a
    long row's in warps of 32, whose sums are then added in warp order."""
    dev = x.device
    n, v = op.ptr.shape[0] - 1, x.shape[1]
    terms = (x * cin.to(x.dtype)).double().index_select(0, op.cols.long())
    ptr = op.ptr.long()
    lengths = ptr[1:] - ptr[:-1]
    long_row = lengths > KL_ROUNDS * op.lanes
    width = torch.where(long_row, KL_THREADS, op.lanes)
    row = torch.repeat_interleave(torch.arange(n, device=dev), lengths)
    lane = (torch.arange(row.numel(), device=dev) - ptr[row]) % width[row]
    # each (row, lane)'s links in link order: a stable sort keeps it
    key = row * KL_THREADS + lane
    order = torch.argsort(key, stable=True)
    groups, counts = torch.unique_consecutive(key[order], return_counts=True)
    part = torch.segment_reduce(terms.index_select(0, order), "sum",
                                lengths=counts, axis=0, unsafe=True) \
        if counts.numel() else terms
    y = torch.zeros((n, v), dtype=torch.float64, device=dev)
    for is_long, w in ((False, op.lanes), (True, KL_THREADS)):
        rows = (long_row == is_long).nonzero().squeeze(1)
        slot = torch.full((n,), -1, dtype=torch.long, device=dev)
        slot[rows] = torch.arange(rows.numel(), device=dev)
        p = torch.zeros((rows.numel() * w, v), dtype=torch.float64,
                        device=dev)
        mine = long_row[groups // KL_THREADS] == is_long
        at = slot[groups[mine] // KL_THREADS] * w + groups[mine] % KL_THREADS
        p[at] = part[mine]
        p = p.view(rows.numel(), w // min(w, 32), min(w, 32), v)  # warps, lanes
        idx = torch.arange(p.shape[2], device=dev)
        o = p.shape[2] // 2
        while o:
            p = p + p[:, :, idx ^ o]
            o //= 2
        s = torch.zeros((rows.numel(), v), dtype=torch.float64, device=dev)
        for warp in range(p.shape[1]):
            s = s + p[:, warp, 0]
        y[rows] = s
    return y.to(x.dtype)


def links_scaled_matvec(op: LinkOperand, x, cin):
    """y = A @ (x ⊙ cin) over K1's link form (``LinkOperand``) of a 0/1
    operator A. x: (n, V); cin: (n, 1) shared or (n, V) per column; all
    contiguous, of one dtype (f64, f32 or bf16). Returns (n, V) in x's
    dtype. CPU tensors run ``links_scaled_matvec_plain``; CUDA tensors
    launch ``csrc/bsr_spmm.cu::links_spmm_kernel`` on the current stream
    (no workspace, no host read: it captures in a CUDA graph)."""
    with tracing.span("k1"):
        if not x.is_cuda:
            return links_scaled_matvec_plain(op, x, cin)
        # one test, its message made only on failure: the whole-crawl loop
        # is paced by the host
        dev, dt = x.device, x.dtype
        n = op.ptr.shape[0] - 1
        v = x.shape[1] if x.dim() == 2 else 0
        if not (dt in _DTYPE_CODE and x.dim() == 2 and x.shape[0] == n
                and x.is_contiguous() and cin.dim() == 2
                and cin.shape[0] == n and cin.shape[1] in (1, v)
                and cin.dtype == dt and cin.device == dev
                and cin.is_contiguous()
                and all(t.dtype == torch.int32 and t.device == dev
                        and t.is_contiguous() for t in op[:3])):
            raise ValueError(
                f"K1's link form takes a contiguous ({n}, V) x of f64, f32 "
                f"or bf16, a contiguous ({n}, 1) or ({n}, V) cin of its "
                "dtype and contiguous int32 ptr, cols and long_rows, all on "
                f"x's device: x {tuple(x.shape)} {dt} on {dev}, cin "
                f"{tuple(cin.shape)} {cin.dtype} on {cin.device}, "
                + ", ".join(f"{t.dtype} on {t.device}" for t in op[:3]))
        out = torch.empty_like(x)
        err = _lib().links_spmm_launch(
            _DTYPE_CODE[dt], op.ptr.data_ptr(), op.cols.data_ptr(),
            op.long_rows.data_ptr(), op.long_rows.numel(), n, op.lanes,
            x.data_ptr(), cin.data_ptr(), cin.shape[1], out.data_ptr(), v,
            _stream(dev))
        counters.k1_links += 1
        counters.bsr_spmm_bytes += op.nbytes
        _raise_on(err, "links_spmm")
        return out


# -------------------------------------------------------- sweep epilogue


def ep_slicing(n: int) -> tuple:
    """(rows per slice, slices) of the epilogue kernels for n rows: about
    ``EP_SLICES`` slices (one CTA each) of a multiple of 16 rows, so every
    slice of the row-major (n, V) arrays starts on 16 bytes."""
    rows = -(-max(int(n), 1) // EP_SLICES)
    rows = -(-rows // 16) * 16
    return rows, -(-max(int(n), 1) // rows)


@dataclasses.dataclass
class EpilogueScratch:
    """The epilogue kernels' workspace: each slice's f64 column sums of
    |hr|, |a| and |hn − h| (3, slices, V), each slice's top-k of a per
    column (slices, V, k), values and indices, and ``cnt``, the second
    kernel's count of finished CTAs (0 between launches)."""

    part: torch.Tensor
    cand_v: torch.Tensor
    cand_i: torch.Tensor
    cnt: torch.Tensor
    rows: int
    slices: int

    @staticmethod
    def make(n: int, v: int, k_eff: int, device) -> "EpilogueScratch":
        rows, slices = ep_slicing(n)
        return EpilogueScratch(
            torch.empty((3, slices, v), dtype=torch.float64, device=device),
            torch.empty((slices, v, k_eff), dtype=torch.float64,
                        device=device),
            torch.empty((slices, v, k_eff), dtype=torch.int32, device=device),
            torch.zeros(1, dtype=torch.int32, device=device), rows, slices)

    def fits(self, n: int, v: int, k_eff: int) -> bool:
        return (ep_slicing(n) == (self.rows, self.slices)
                and self.part.shape[2] == v and self.cand_v.shape[2] == k_eff)


@dataclasses.dataclass
class LoopState:
    """Device state of the convergence loop.

    ``ctl`` = [stop flag (1 while sweeping), sweep count k] is shared by
    the phases of one loop, so k carries across the ladder's switch;
    ``conv``/``stab``/``top`` are per phase (the rank state resets at the
    switch). ``top`` is (V, k_eff) — k_eff 0 turns the rank-stability rule
    off. ``ep`` is the epilogue kernels' workspace (made at the first
    launch when None).
    """

    ctl: torch.Tensor     # (2,) int32
    conv: torch.Tensor    # (V,) int32, -1 while running
    stop: torch.Tensor    # (V,) int32, this sweep's stop decision
    stab: torch.Tensor    # (V,) int32, sweeps with an unchanged top-k
    top: torch.Tensor     # (V, k_eff) int32, last top-k (-1: none yet)
    delta: torch.Tensor   # (V,) f64, this sweep's residual
    ep: Optional[EpilogueScratch] = None

    @staticmethod
    def start(ctl, v: int, k_eff: int, max_iter: int) -> "LoopState":
        """Fresh per-phase state; arms the flag iff k < max_iter (on
        device, no sync)."""
        dev = ctl.device
        ctl[0:1].copy_(ctl[1:2] < max_iter)
        i32 = dict(dtype=torch.int32, device=dev)
        return LoopState(ctl=ctl, conv=torch.full((v,), -1, **i32),
                         stop=torch.zeros(v, **i32),
                         stab=torch.zeros(v, **i32),
                         top=torch.full((v, k_eff), -1, **i32),
                         delta=torch.zeros(v, dtype=torch.float64,
                                           device=dev))


def sweep_epilogue_plain(hr, h, a, st: LoopState, *, tol: float,
                         stable_sweeps: int, max_iter: int):
    """Plain torch epilogue, in place on ``h`` and ``st``: while the flag
    is set, h ← hr/(‖hr‖₁+1e-30) per column, residual, rank stability on
    the top-k of ``a``, conv/k/flag update. ``hr`` is the new masked hub
    vector before normalization."""
    if int(st.ctl[0]) == 0:
        return
    hn = hr / (_l1(hr) + _EPS)
    delta = _l1(hn - h)[0]
    h.copy_(hn)
    stop = delta.double() <= tol_in(tol, delta.dtype)
    k_eff = st.top.shape[1]
    if k_eff:
        # stable descending sort: lowest index first among equal scores
        top = torch.sort(a.T.double(), dim=1, descending=True,
                         stable=True).indices[:, :k_eff].int()
        same = (top == st.top).all(dim=1)
        st.stab.copy_(torch.where(same, st.stab + 1, 0))
        st.top.copy_(top)
        stop = stop | (st.stab >= stable_sweeps)
    st.stop.copy_(stop)
    st.delta.copy_(delta.double())
    k1 = int(st.ctl[1]) + 1
    st.conv.copy_(torch.where((st.conv < 0) & stop, k1, st.conv))
    st.ctl[1] = k1
    st.ctl[0] = int(k1 < max_iter and bool((st.conv < 0).any()))


def _launch_epilogue(hr, h, a, st: Optional[LoopState], res,
                     ep: Optional[EpilogueScratch], *, tol: float,
                     stable_sweeps: int, max_iter: int):
    """The epilogue's two kernels (slice sums and top-k; normalize, merge,
    control) on ``st`` (a sweep, workspace ``st.ep``) or into ``res`` (the
    certificate, st None, workspace ``ep`` or a new one)."""
    dev = h.device
    dt = h.dtype
    _check(dt in _DTYPE_CODE, f"epilogue takes f64, f32 or bf16, not {dt}")
    n, v = h.shape
    _check(1 <= v <= EP_MAXV, f"epilogue takes 1 to {EP_MAXV} columns, not {v}")
    for name, t in (("hr", hr), ("h", h), ("a", a)):
        _check(t.device == dev and t.dtype == dt and t.is_contiguous()
               and tuple(t.shape) == (n, v),
               f"{name} must be a contiguous ({n}, {v}) {dt} on {dev}")
    if st is None:  # certificate
        _check(res.dtype == torch.float64 and res.numel() == v
               and res.device == dev, "res must be (V,) f64 on the device")
        k_eff, mode = 0, 1
        if ep is None or not ep.fits(n, v, ep.cand_v.shape[2]):
            ep = EpilogueScratch.make(n, v, 0, dev)
        state = (None, None, None, None, None, res.data_ptr())
    else:
        k_eff, mode = st.top.shape[1], 0
        if st.ep is None or not st.ep.fits(n, v, k_eff):
            st.ep = EpilogueScratch.make(n, v, k_eff, dev)
        ep = st.ep
        state = (st.ctl.data_ptr(), st.conv.data_ptr(), st.stop.data_ptr(),
                 st.stab.data_ptr(), _ptr(st.top), st.delta.data_ptr())
    _check(ep.part.device == dev, f"epilogue workspace on {ep.part.device}")
    err = _lib().sweep_epilogue_launch(
        _DTYPE_CODE[dt], hr.data_ptr(), h.data_ptr(), a.data_ptr(), n, v,
        ep.rows, ep.slices, k_eff, mode, tol_in(tol, dt), int(max_iter),
        int(stable_sweeps), state[0], ep.cnt.data_ptr(), *state[1:],
        ep.part.data_ptr(), _ptr(ep.cand_v), _ptr(ep.cand_i), _stream(dev))
    counters.sweep_epilogue += 2
    _raise_on(err, "sweep_epilogue")


def sweep_epilogue(hr, h, a, st: LoopState, *, tol: float,
                   stable_sweeps: int, max_iter: int):
    """One sweep's epilogue (see ``sweep_epilogue_plain``), as the two
    epilogue kernels, predicated on ``st.ctl[0]``; no host sync."""
    if not h.is_cuda:
        return sweep_epilogue_plain(hr, h, a, st, tol=tol,
                                    stable_sweeps=stable_sweeps,
                                    max_iter=max_iter)
    _launch_epilogue(hr, h, a, st, None, None, tol=tol,
                     stable_sweeps=stable_sweeps, max_iter=max_iter)


def sweep_certificate_plain(hr, h, a):
    """Plain torch certificate: res[j] = ‖hr/(‖hr‖₁+eps) − h‖₁ per column
    (returned, f64), and ``a`` L1-normalized in place."""
    hn = hr / (_l1(hr) + _EPS)
    res = _l1(hn - h)[0].double()
    a.copy_(a / (_l1(a) + _EPS))
    return res


def sweep_certificate(hr, h, a, ep: Optional[EpilogueScratch] = None):
    """The loop's closing certificate (see ``sweep_certificate_plain``), on
    the workspace ``ep`` (a loop's ``LoopState.ep``) or a new one."""
    if not h.is_cuda:
        return sweep_certificate_plain(hr, h, a)
    res = torch.empty(h.shape[1], dtype=torch.float64, device=h.device)
    _launch_epilogue(hr, h, a, None, res, ep, tol=0.0, stable_sweeps=0,
                     max_iter=0)
    return res


# ------------------------------------------------------- convergence loop


def bsr_converge_cols_plain(lt: BsrOperand, lf: BsrOperand, h0, ca, ch,
                            mask, tol: float, *, bs: int, accum_dtype=None,
                            max_iter: int, rank_k: int = 0,
                            stable_sweeps: int = 2,
                            lt_lo: Optional[BsrOperand] = None,
                            lf_lo: Optional[BsrOperand] = None,
                            bulk_tol: float = 0.0, bulk_dtype=None):
    """Plain torch K2: the per-sweep loop of the reference's
    ``bsr_converge_cols``, line for line, with the host deciding every
    sweep. Returns (h, a, conv, res)."""
    def make_sweep(lt_op, lf_op, cav, chv, mv, accum):
        def sweep(h):
            a = bsr_scaled_matvec_plain(*lt_op, h, chv, bs=bs,
                                        accum_dtype=accum, mask=mv)
            h_new = bsr_scaled_matvec_plain(*lf_op, a, cav, bs=bs,
                                            accum_dtype=accum, mask=mv)
            return h_new / (_l1(h_new) + _EPS), a
        return sweep

    k_eff = min(int(rank_k), h0.shape[0]) if rank_k else 0
    v = h0.shape[1]
    i32 = dict(dtype=torch.int32, device=h0.device)

    def loop(sweep_fn, h, k, stop_tol):
        conv = torch.full((v,), -1, **i32)
        top_prev = torch.full((v, k_eff), -1, **i32)
        stab = torch.zeros(v, **i32)
        while k < max_iter and bool((conv < 0).any()):
            h_new, a = sweep_fn(h)
            delta = _l1(h_new - h)[0]
            stop = delta.double() <= tol_in(stop_tol, delta.dtype)
            if k_eff:
                top = torch.sort(a.T.double(), dim=1, descending=True,
                                 stable=True).indices[:, :k_eff].int()
                same = (top == top_prev).all(dim=1)
                stab = torch.where(same, stab + 1, 0)
                stop = stop | (stab >= stable_sweeps)
                top_prev = top
            conv = torch.where((conv < 0) & stop, k + 1, conv)
            h, k = h_new, k + 1
        return h, k, conv

    accum = natural_accum(lt.blocks.dtype) if accum_dtype is None \
        else torch_dtype(accum_dtype)
    sweep_hi = make_sweep(lt, lf, ca, ch, mask, accum)
    k = 0
    if bulk_dtype is not None:
        bd = torch_dtype(bulk_dtype)
        sweep_lo = make_sweep(lt_lo, lf_lo, ca.to(bd), ch.to(bd),
                              mask.to(bd), torch.float32)
        h_lo, k, _ = loop(sweep_lo, h0.to(bd), k, bulk_tol)
        h0 = h_lo.to(h0.dtype)
    h, k, conv = loop(sweep_hi, h0, k, tol)
    conv = torch.where(conv < 0, k, conv)
    h2, a = sweep_hi(h)
    res = _l1(h2 - h)[0].double()
    a = a / (_l1(a) + _EPS)
    return h, a, conv, res


# ------------------------------------------------------------- K2's graph

STEP_OPS = {"reset": 0, "while": 1, "spmm": 2, "epilogue": 3, "cast": 4,
            "finish": 5, "certificate": 6}
PHASES = ("hi", "lo")  # full precision; the ladder's bulk phase


def k2_steps(ladder: bool) -> tuple:
    """K2 as a list of (op, phase, arg) steps: the description that
    ``K2Graph`` hands to the CUDA builder, which captures each step, and
    that ``k2_rehearse`` interprets with the plain versions.

    * ``reset``: start a phase (conv −1, stab 0, top −1), k = 0 when arg
      is 1, and set the stop flag / WHILE condition to k < max_iter;
    * ``while``: run the body (arg, a step list) while the condition
      holds, testing it before each iteration;
    * ``spmm``: K1 on Lᵀ (arg 0: h → a) or L (arg 1: a → hr);
    * ``epilogue``: the sweep's epilogue, which updates the condition;
    * ``cast``: the bulk phase's h widened into the full-precision h;
    * ``finish``: conv = where(conv < 0, k, conv);
    * ``certificate``: res = ‖normalize(hr) − h‖₁, a normalized.
    """
    def sweep(p):
        return (("spmm", p, 0), ("spmm", p, 1), ("epilogue", p, 0))
    steps = ()
    if ladder:
        steps += (("reset", "lo", 1), ("while", "lo", sweep("lo")),
                  ("cast", "hi", 0))
    return steps + (("reset", "hi", 0 if ladder else 1),
                    ("while", "hi", sweep("hi")), ("finish", "hi", 0),
                    ("spmm", "hi", 0), ("spmm", "hi", 1),
                    ("certificate", "hi", 0))


def _encode_steps(steps) -> list:
    """The steps as the builder reads them: (op, phase, arg) int triples,
    a WHILE's arg its body's length, the body's triples right after it."""
    out = []
    for op, ph, arg in steps:
        if op == "while":
            out += [STEP_OPS[op], PHASES.index(ph), len(arg)]
            out += _encode_steps(arg)
        else:
            out += [STEP_OPS[op], PHASES.index(ph), int(arg)]
    return out


@dataclasses.dataclass
class _PhaseBuffers:
    lt: BsrOperand
    lf: BsrOperand
    h: torch.Tensor   # (n_pad, V), updated in place by the epilogue
    a: torch.Tensor
    hr: torch.Tensor  # the new hub vector before normalization
    ca: torch.Tensor
    ch: torch.Tensor
    mask: torch.Tensor


class K2Buffers:
    """Every tensor one K2 call's steps read or write: per phase the
    operators and the (n_pad, V) vectors (the first phase's h a copy of h0;
    ca/ch/mask the caller's tensors where their dtype is the phase's), the
    loop state shared by the phases with its epilogue workspace, the
    certificate ``res``, K1's ``Scratch``, and ``launches`` = [K1 in the
    full-precision phase, epilogue, K1 in the bulk phase] kernels the
    graph launched, counted on the device. The
    call's values ride along: ``tol`` per phase (full precision, bulk),
    ``max_iter`` and ``stable_sweeps``."""

    def __init__(self, lt, lf, lt_lo, lf_lo, h0, ca, ch, mask, *, bs: int,
                 bulk_dtype, k_eff: int, tol: float, bulk_tol: float,
                 max_iter: int, stable_sweeps: int):
        n_pad, v = h0.shape
        dev, dt = h0.device, h0.dtype

        def phase(t_op, f_op, pdt, first):
            h = h0.to(pdt, memory_format=torch.contiguous_format, copy=True) \
                if first else torch.empty((n_pad, v), dtype=pdt, device=dev)
            return _PhaseBuffers(t_op, f_op, h, torch.empty_like(h),
                                 torch.empty_like(h),
                                 *(x.to(pdt).contiguous()
                                   for x in (ca, ch, mask)))
        self.phases = {"hi": phase(lt, lf, dt, bulk_dtype is None)}
        if bulk_dtype is not None:
            self.phases["lo"] = phase(lt_lo, lf_lo, bulk_dtype, True)
        self.state = LoopState.start(
            torch.zeros(2, dtype=torch.int32, device=dev), v, k_eff, 0)
        self.state.ep = EpilogueScratch.make(n_pad, v, k_eff, dev)
        self.res = torch.zeros(v, dtype=torch.float64, device=dev)
        ops = [o for p in self.phases.values() for o in (p.lt, p.lf)]
        self.scratch = _reserve_k1(Scratch(dev), ops, bs, v)
        self.launches = torch.zeros(3, dtype=torch.int64, device=dev)
        self.n_pad, self.v, self.k_eff, self.bs = n_pad, v, k_eff, bs
        self.tol = (tol_in(tol, dt), 0.0 if bulk_dtype is None
                    else tol_in(bulk_tol, bulk_dtype))
        self.max_iter, self.stable_sweeps = int(max_iter), int(stable_sweeps)


def _run_steps_plain(steps, b: K2Buffers, runs: dict):
    """Interpret ``steps`` on ``b`` with the plain versions; ``runs``
    counts the steps run per (op, phase)."""
    st = b.state
    for op, ph, arg in steps:
        if op == "while":
            while int(st.ctl[0]):  # tested before each iteration
                _run_steps_plain(arg, b, runs)
            continue
        runs[op, ph] = runs.get((op, ph), 0) + 1
        p = b.phases[ph]
        if op == "reset":
            if arg:
                st.ctl[1] = 0
            st.conv.fill_(-1)
            st.stab.zero_()
            st.top.fill_(-1)
            st.ctl[0] = int(int(st.ctl[1]) < b.max_iter)
        elif op == "spmm":
            op_, x, cin, out = (p.lt, p.h, p.ch, p.a) if arg == 0 else \
                (p.lf, p.a, p.ca, p.hr)
            out.copy_(bsr_scaled_matvec_plain(*op_, x, cin, bs=b.bs,
                                              mask=p.mask))
        elif op == "epilogue":
            sweep_epilogue_plain(p.hr, p.h, p.a, st,
                                 tol=b.tol[PHASES.index(ph)],
                                 stable_sweeps=b.stable_sweeps,
                                 max_iter=b.max_iter)
        elif op == "cast":
            b.phases["hi"].h.copy_(b.phases["lo"].h)
        elif op == "finish":
            st.conv.copy_(torch.where(st.conv < 0, st.ctl[1], st.conv))
        elif op == "certificate":
            b.res.copy_(sweep_certificate_plain(p.hr, p.h, p.a))
        else:
            raise ValueError(f"unknown K2 step {op!r}")


def k2_rehearse(lt: BsrOperand, lf: BsrOperand, h0, ca, ch, mask,
                tol: float, *, bs: int, max_iter: int, rank_k: int = 0,
                stable_sweeps: int = 2, lt_lo: Optional[BsrOperand] = None,
                lf_lo: Optional[BsrOperand] = None, bulk_tol: float = 0.0,
                bulk_dtype=None):
    """K2's graph rehearsed on the CPU: the buffers and the step list
    (``k2_steps``) that ``K2Graph`` captures, interpreted with the plain
    versions under WHILE semantics. Returns ((h, a, conv, res), {(op,
    phase): times run})."""
    k_eff = min(int(rank_k), h0.shape[0]) if rank_k else 0
    bd = None if bulk_dtype is None else torch_dtype(bulk_dtype)
    b = K2Buffers(lt, lf, lt_lo, lf_lo, h0, ca, ch, mask, bs=bs,
                  bulk_dtype=bd, k_eff=k_eff, tol=tol, bulk_tol=bulk_tol,
                  max_iter=max_iter, stable_sweeps=stable_sweeps)
    runs = {}
    _run_steps_plain(k2_steps(bd is not None), b, runs)
    hi = b.phases["hi"]
    return (hi.h, hi.a, b.state.conv, b.res), runs


class _K2Operand(ctypes.Structure):
    _fields_ = [("blocks", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("row_ptr", ctypes.c_void_p), ("nblocks", ctypes.c_longlong)]


class _K2Phase(ctypes.Structure):
    _fields_ = [("lt", _K2Operand), ("lf", _K2Operand)] + [
        (n, ctypes.c_void_p) for n in ("h", "a", "hr", "ca", "ch", "mask")] \
        + [("dtype", ctypes.c_longlong)]


class _K2Args(ctypes.Structure):
    """``K2Args`` of ``csrc/bsr_spmm.cu`` (checked against
    ``k2_args_size()`` at load)."""

    _fields_ = [("phase", _K2Phase * 2), ("steps", ctypes.c_void_p),
                ("n_steps", ctypes.c_longlong)] + [
        (n, ctypes.c_void_p) for n in (
            "ctl", "conv", "stop", "stab", "top", "delta", "res", "part",
            "cand_v", "cand_i", "ep_cnt", "ws", "cnt", "launches")] + [
        (n, ctypes.c_longlong) for n in (
            "n_pad", "V", "bs", "rank_k", "ep_rows", "ep_slices", "max_iter",
            "stable_sweeps")] + [
        ("tol", ctypes.c_double), ("bulk_tol", ctypes.c_double)]


class K2Graph:
    """K2 as one executable CUDA graph: ``k2_steps`` captured by
    ``csrc/bsr_spmm.cu::k2_graph_build`` over the pointers and values of
    one call's ``K2Buffers``, so it serves that call only. ``run`` launches
    it and reads the device's launch counts once; ``destroy`` frees it.
    ``build_ms`` is the build's host time (capture plus instantiate)."""

    def __init__(self, b: K2Buffers):
        self.bufs = b
        codes = _encode_steps(k2_steps("lo" in b.phases))
        steps = (ctypes.c_longlong * len(codes))(*codes)
        args = _K2Args(steps=ctypes.addressof(steps),
                       n_steps=len(codes) // 3)
        for i, name in enumerate(PHASES):
            p = b.phases.get(name)
            if p is None:
                continue
            ph = args.phase[i]
            for field, op in (("lt", p.lt), ("lf", p.lf)):
                setattr(ph, field, _K2Operand(
                    op.blocks.data_ptr(), op.idx.data_ptr(),
                    op.row_ptr.data_ptr(), op.blocks.shape[0]))
            for field in ("h", "a", "hr", "ca", "ch", "mask"):
                setattr(ph, field, getattr(p, field).data_ptr())
            ph.dtype = _DTYPE_CODE[p.h.dtype]
        st = b.state
        for field, t in (("ctl", st.ctl), ("conv", st.conv),
                         ("stop", st.stop), ("stab", st.stab),
                         ("top", st.top), ("delta", st.delta),
                         ("res", b.res), ("part", st.ep.part),
                         ("cand_v", st.ep.cand_v), ("cand_i", st.ep.cand_i),
                         ("ep_cnt", st.ep.cnt), ("ws", b.scratch.ws),
                         ("cnt", b.scratch.cnt), ("launches", b.launches)):
            setattr(args, field, _ptr(t))
        args.n_pad, args.V, args.bs, args.rank_k = b.n_pad, b.v, b.bs, b.k_eff
        args.ep_rows, args.ep_slices = st.ep.rows, st.ep.slices
        args.max_iter, args.stable_sweeps = b.max_iter, b.stable_sweeps
        args.tol, args.bulk_tol = b.tol
        exe = ctypes.c_void_p()
        t0 = time.perf_counter()
        err = _lib().k2_graph_build(ctypes.byref(args), ctypes.byref(exe))
        self.build_ms = (time.perf_counter() - t0) * 1e3
        _raise_on(err, "k2_graph_build")
        counters.k2_graph_builds += 1
        self.exec = exe.value

    def run(self):
        """Launch the graph once; returns (h, a, conv, res), the buffers'
        own tensors."""
        b = self.bufs
        _raise_on(_lib().k2_graph_launch(self.exec, _stream(b.res.device)),
                  "k2_graph")
        k1, ep, k1_lo = b.launches.tolist()  # the call's one host read
        counters.host_syncs += 1
        counters.bsr_converge += 1
        counters.bsr_spmm += k1 + k1_lo
        counters.sweep_epilogue += ep
        # a phase's K1 launches go to Lᵀ and L in turn, as many to each
        for name, n in (("hi", k1), ("lo", k1_lo)):
            if n:
                p = b.phases[name]
                counters.bsr_spmm_bytes += n // 2 * (p.lt.nbytes
                                                     + p.lf.nbytes)
        hi = b.phases["hi"]
        return hi.h, hi.a, b.state.conv, b.res

    def destroy(self):
        if self.exec:
            _raise_on(_lib().k2_graph_destroy(self.exec), "k2_graph_destroy")
            self.exec = None


def bsr_converge_cols(lt: BsrOperand, lf: BsrOperand, h0, ca, ch, mask,
                      tol: float, *, bs: int, accum_dtype=None,
                      max_iter: int, rank_k: int = 0, stable_sweeps: int = 2,
                      lt_lo: Optional[BsrOperand] = None,
                      lf_lo: Optional[BsrOperand] = None,
                      bulk_tol: float = 0.0, bulk_dtype=None):
    """Masked multi-column accelerated-HITS convergence over two BSR
    operators (K2).

    One sweep: a = Lᵀ(h ⊙ ch) ⊙ m; h' = L(a ⊙ ca) ⊙ m; h' ← h'/(‖h'‖₁+1e-30).
    ``conv[j]`` is the first sweep at which column j's L1 residual reached
    ``tol`` (or, with ``rank_k > 0``, its top-``rank_k`` authority order
    held ``stable_sweeps`` sweeps — ties to the lowest index, in the
    operator's node order), and the final sweep count where neither fired;
    all columns sweep until every column stopped or ``max_iter``.
    ``bulk_dtype`` arms the ladder: the loop first runs on ``lt_lo``/
    ``lf_lo`` (the operators cast to that dtype, f32 accumulation) to
    ``bulk_tol``, the rank state resets, and ``max_iter`` bounds the total.
    One extra full-precision sweep gives the certificate ``res`` and the
    published authority. h0/ca/ch/mask: (n_pad, V). Returns (h, a, conv,
    res) on the inputs' device.

    CPU tensors run ``bsr_converge_cols_plain``. CUDA tensors run the loop
    as one CUDA graph (``K2Graph``), built for the call, launched once, read
    once and destroyed.
    """
    if bulk_dtype is not None and (lt_lo is None or lf_lo is None):
        raise ValueError("bulk_dtype set but lt_lo/lf_lo operators missing")
    if not h0.is_cuda:
        return bsr_converge_cols_plain(
            lt, lf, h0, ca, ch, mask, tol, bs=bs, accum_dtype=accum_dtype,
            max_iter=max_iter, rank_k=rank_k, stable_sweeps=stable_sweeps,
            lt_lo=lt_lo, lf_lo=lf_lo, bulk_tol=bulk_tol,
            bulk_dtype=bulk_dtype)
    dev, dt = h0.device, h0.dtype
    n_pad, v = h0.shape
    _check(dt in _DTYPE_CODE, f"K2 takes f64, f32 or bf16, not {dt}")
    acc = natural_accum(dt) if accum_dtype is None else torch_dtype(accum_dtype)
    _check(acc == natural_accum(dt),
           f"K1 accumulates {dt} in {natural_accum(dt)}, not {acc}")
    _check(1 <= v <= EP_MAXV, f"K2 takes 1 to {EP_MAXV} columns, not {v}")
    for name, t in (("h0", h0), ("ca", ca), ("ch", ch), ("mask", mask)):
        _check(t.device == dev and tuple(t.shape) == (n_pad, v),
               f"{name} must be ({n_pad}, {v}) on {dev}")
    bd = None if bulk_dtype is None else torch_dtype(bulk_dtype)
    ops = [(lt, dt, "lt"), (lf, dt, "lf")]
    if bd is not None:
        _check(bd in _DTYPE_CODE, f"the ladder takes f32 or bf16, not {bd}")
        ops += [(lt_lo, bd, "lt_lo"), (lf_lo, bd, "lf_lo")]
    for op, odt, what in ops:
        _check_operand(op, bs, n_pad, odt, dev, what)
    k_eff = min(int(rank_k), n_pad) if rank_k else 0
    graph = K2Graph(K2Buffers(
        lt, lf, lt_lo, lf_lo, h0, ca, ch, mask, bs=bs, bulk_dtype=bd,
        k_eff=k_eff, tol=float(tol), bulk_tol=float(bulk_tol),
        max_iter=max_iter, stable_sweeps=stable_sweeps))
    try:
        return graph.run()
    finally:
        graph.destroy()


# ------------------------------------------------- power_method_jit's graph


class PowerGraph:
    """``core.power.power_method_jit`` on the card as one executable CUDA
    graph (``csrc/bsr_spmm.cu::pm_graph_build``): an init kernel (k = 0,
    delta = inf, condition = max_iter > 0), then a WHILE node whose body is
    ``sweep_graph`` (a ``cudaGraph_t``: the caller's captured chunk of
    ``check_every`` sweeps, which starts with v_prev = v) as a child graph,
    followed by the residual kernel: delta = max over columns of
    ‖v − v_prev‖₁, k += check_every, condition = k < max_iter and delta >
    tol. ``v``/``v_prev`` (n,) or (n, V), ``k`` an int64 and ``delta`` an
    f64 device scalar; every pointer must outlive the graph."""

    def __init__(self, sweep_graph: int, v, v_prev, k, delta, *,
                 check_every: int, max_iter: int, tol: float):
        _check(v.is_cuda and v.dtype in _DTYPE_CODE and v.is_contiguous()
               and v_prev.shape == v.shape and v_prev.dtype == v.dtype
               and v_prev.is_contiguous(),
               "v/v_prev must be contiguous f64/f32/bf16 of one shape on "
               "the card")
        _check(k.dtype == torch.int64 and delta.dtype == torch.float64
               and k.device == v.device == delta.device,
               "k must be int64 and delta f64, on v's device")
        self.device = v.device
        exe = ctypes.c_void_p()
        err = _lib().pm_graph_build(
            sweep_graph, _DTYPE_CODE[v.dtype], v.data_ptr(),
            v_prev.data_ptr(), v.shape[0], v.shape[1] if v.dim() == 2 else 1,
            k.data_ptr(), delta.data_ptr(), int(check_every), int(max_iter),
            tol_in(tol, v.dtype), ctypes.byref(exe))
        _raise_on(err, "pm_graph_build")
        self.exec = exe.value

    def launch(self):
        _raise_on(_lib().k2_graph_launch(self.exec, _stream(self.device)),
                  "power_method_jit graph")

    def destroy(self):
        if self.exec:
            _raise_on(_lib().k2_graph_destroy(self.exec), "k2_graph_destroy")
            self.exec = None
