"""Block-sparse (BSR) matrix x multi-vector with fused diagonal scaling,
and the on-device accelerated-HITS convergence loop around it.

Port of ``repro.kernels.bsr_spmm``. Three wrappers, each with a plain
PyTorch version of the same signature beside it:

* ``bsr_scaled_matvec`` (K1, replaces the Pallas kernel ``_bsr_kernel``):
  y = (A_bsr @ (x ⊙ cin)) ⊙ mask, launched as the CUDA kernel
  ``csrc/bsr_spmm.cu::bsr_spmm_kernel``: one CTA per (block, slice of
  ``K1_ROWS`` rows) writes the block's rounded product to a workspace, and
  the last CTA of each block row adds them in idx order (``Scratch``).
* ``sweep_epilogue`` / ``sweep_certificate``: the per-sweep epilogue of the
  loop (normalize, residual, rank stability, conv, stop flag) and the
  final certificate, as ``csrc/bsr_spmm.cu::sweep_epilogue_kernel``.
* ``bsr_converge_cols`` (K2, replaces the Pallas loop
  ``bsr_converge_cols``): the masked multi-column loop, with the
  precision ladder and the residual certificate. On the card it keeps all
  state on the device, enqueues sweeps in chunks of ``CHUNK`` with every
  kernel predicated on the device stop flag, and reads that flag once per
  chunk — no host sync per sweep.

A wrapper runs its plain version only when it is given CPU tensors; for
CUDA tensors it launches its kernel or raises. The kernels build at first
use (``kernels.build``), which also holds ``counters``: one object, shared
with K3, that counts launches per wrapper and the loop's host syncs;
``reset_counters()`` zeroes them.

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
from typing import NamedTuple, Optional

import torch

from ..runtime import tol_in, torch_dtype
from . import build as _build
from .build import Scratch, counters, reset_counters  # noqa: F401

_DTYPE_CODE = {torch.float64: 0, torch.float32: 1, torch.bfloat16: 2}
BLOCK_SIZES = (16, 32, 64, 128)
V_GROUP = 16   # widest column group one K1 launch takes
K1_ROWS = 32   # rows of a block one K1 CTA takes (bs 16: all 16)
CHUNK = 8      # sweeps enqueued between two reads of the stop flag
_EPS = 1e-30


class BsrOperand(NamedTuple):
    """The three tensors K1 reads of one BSR operator: blocks
    (nblocks, bs, bs), idx (nblocks, 2) int32 (brow, bcol) sorted by brow,
    and row_ptr (n_brows + 1,) int32 (block row r owns blocks
    row_ptr[r]:row_ptr[r+1])."""

    blocks: torch.Tensor
    idx: torch.Tensor
    row_ptr: torch.Tensor


def natural_accum(dtype) -> torch.dtype:
    """The kernel's accumulator for a block dtype: f64 for f64, else f32."""
    return torch.float64 if torch_dtype(dtype) == torch.float64 \
        else torch.float32


def _declare(lib):
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.bsr_spmm_launch.argtypes = [i, i, i, p, p, p, i, i, p, p, i, p, p, i,
                                    i, i, p, p, p, p]
    lib.bsr_spmm_launch.restype = i
    lib.sweep_epilogue_launch.argtypes = [i, p, p, p, i, i, d, i, i, p, p, p,
                                          p, p, p, i, i, p]
    lib.sweep_epilogue_launch.restype = i


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


def _launch_spmm(op: BsrOperand, x, cin, bs: int, accum_dtype, mask, out,
                 active=None, scratch: Optional[Scratch] = None):
    """Validate and launch K1 into ``out``; V wider than ``V_GROUP`` runs as
    column groups, one launch each, one after another on one ``scratch``
    (made here when None)."""
    blocks, idx, row_ptr = op
    dev = x.device
    dt = x.dtype
    _check(dt in _DTYPE_CODE, f"K1 takes f64, f32 or bf16, not {dt}")
    _check(bs in BLOCK_SIZES, f"K1 block size {bs} not in {BLOCK_SIZES}")
    acc = natural_accum(dt) if accum_dtype is None else torch_dtype(accum_dtype)
    _check(acc == natural_accum(dt),
           f"K1 accumulates {dt} in {natural_accum(dt)}, not {acc}")
    n_pad, v = x.shape
    nblocks = blocks.shape[0]
    n_brows = row_ptr.shape[0] - 1
    _check(n_pad == n_brows * bs, f"x has {n_pad} rows, operator {n_brows}x{bs}")
    _check(tuple(blocks.shape) == (nblocks, bs, bs) and tuple(idx.shape)
           == (nblocks, 2), "blocks/idx shapes do not match")
    _check(cin.shape[0] == n_pad and cin.shape[1] in (1, v),
           f"cin must be ({n_pad}, 1) or ({n_pad}, {v})")
    for name, t in (("blocks", blocks), ("x", x), ("cin", cin),
                    ("mask", mask), ("out", out)):
        if t is None:
            continue
        _check(t.device == dev, f"{name} on {t.device}, x on {dev}")
        _check(t.dtype == dt, f"{name} is {t.dtype}, x is {dt}")
        _check(t.is_contiguous(), f"{name} must be contiguous")
    for name, t in (("idx", idx), ("row_ptr", row_ptr)):
        _check(t.device == dev and t.dtype == torch.int32
               and t.is_contiguous(), f"{name} must be contiguous int32 "
               f"on {dev}")
    for t in (mask, out):
        _check(t is None or tuple(t.shape) == (n_pad, v),
               f"mask/out must be ({n_pad}, {v})")
    scratch = _reserve_k1(Scratch.on(dev, scratch), [op], bs, v)
    lib = _lib()
    stream = _stream(dev)
    for col0 in range(0, v, V_GROUP):
        vg = min(V_GROUP, v - col0)
        err = lib.bsr_spmm_launch(
            _DTYPE_CODE[dt], bs, _vt(vg), blocks.data_ptr(), idx.data_ptr(),
            row_ptr.data_ptr(), nblocks, n_brows, x.data_ptr(),
            cin.data_ptr(), cin.shape[1], _ptr(mask), out.data_ptr(), v,
            col0, vg, scratch.ws.data_ptr(), scratch.cnt.data_ptr(),
            _ptr(active), stream)
        counters.bsr_spmm += 1
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
    if not x.is_cuda:
        return bsr_scaled_matvec_plain(blocks, idx, row_ptr, x, cin, bs=bs,
                                       accum_dtype=accum_dtype, mask=mask)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    return _launch_spmm(BsrOperand(blocks, idx, row_ptr), x, cin, bs,
                        accum_dtype, mask, out, scratch=scratch)


# -------------------------------------------------------- sweep epilogue


@dataclasses.dataclass
class LoopState:
    """Device state of one phase of the convergence loop.

    ``ctl`` = [stop flag (1 while sweeping), sweep count k, epilogue CTAs
    finished this sweep] is shared by the phases of one loop, so k carries
    across the ladder's switch; ``conv``/``stab``/``top`` are per phase
    (the rank state resets at the switch). ``top`` is (V, k_eff) — k_eff 0
    turns the rank-stability rule off.
    """

    ctl: torch.Tensor     # (3,) int32
    conv: torch.Tensor    # (V,) int32, -1 while running
    stop: torch.Tensor    # (V,) int32, this sweep's stop decision
    stab: torch.Tensor    # (V,) int32, sweeps with an unchanged top-k
    top: torch.Tensor     # (V, k_eff) int32, last top-k (-1: none yet)
    delta: torch.Tensor   # (V,) f64, this sweep's residual

    @staticmethod
    def start(ctl, v: int, k_eff: int, max_iter: int) -> "LoopState":
        """Fresh per-phase state; arms the flag iff k < max_iter (on
        device, no sync)."""
        dev = ctl.device
        ctl[0:1].copy_(ctl[1:2] < max_iter)
        ctl[2] = 0
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


def _launch_epilogue(hr, h, a, st: Optional[LoopState], res, *, tol: float,
                     stable_sweeps: int, max_iter: int):
    dev = h.device
    dt = h.dtype
    _check(dt in _DTYPE_CODE, f"epilogue takes f64, f32 or bf16, not {dt}")
    n, v = h.shape
    for name, t in (("hr", hr), ("h", h), ("a", a)):
        _check(t.device == dev and t.dtype == dt and t.is_contiguous()
               and tuple(t.shape) == (n, v),
               f"{name} must be a contiguous ({n}, {v}) {dt} on {dev}")
    if st is None:  # certificate
        _check(res.dtype == torch.float64 and res.numel() == v
               and res.device == dev, "res must be (V,) f64 on the device")
        args = (0.0, 0, 1, None, None, None, None, res.data_ptr(), None, 0, 1)
    else:
        k_eff = st.top.shape[1]
        args = (tol_in(tol, dt), k_eff, int(stable_sweeps), _ptr(st.top),
                st.stab.data_ptr(), st.stop.data_ptr(), st.conv.data_ptr(),
                st.delta.data_ptr(), st.ctl.data_ptr(), int(max_iter), 0)
    err = _lib().sweep_epilogue_launch(
        _DTYPE_CODE[dt], hr.data_ptr(), h.data_ptr(), a.data_ptr(), n, v,
        *args, _stream(dev))
    counters.sweep_epilogue += 1
    _raise_on(err, "sweep_epilogue")


def sweep_epilogue(hr, h, a, st: LoopState, *, tol: float,
                   stable_sweeps: int, max_iter: int):
    """One sweep's epilogue (see ``sweep_epilogue_plain``), as one kernel
    launch predicated on ``st.ctl[0]``; no host sync."""
    if not h.is_cuda:
        return sweep_epilogue_plain(hr, h, a, st, tol=tol,
                                    stable_sweeps=stable_sweeps,
                                    max_iter=max_iter)
    _launch_epilogue(hr, h, a, st, None, tol=tol,
                     stable_sweeps=stable_sweeps, max_iter=max_iter)


def sweep_certificate_plain(hr, h, a):
    """Plain torch certificate: res[j] = ‖hr/(‖hr‖₁+eps) − h‖₁ per column
    (returned, f64), and ``a`` L1-normalized in place."""
    hn = hr / (_l1(hr) + _EPS)
    res = _l1(hn - h)[0].double()
    a.copy_(a / (_l1(a) + _EPS))
    return res


def sweep_certificate(hr, h, a):
    """The loop's closing certificate (see ``sweep_certificate_plain``)."""
    if not h.is_cuda:
        return sweep_certificate_plain(hr, h, a)
    res = torch.empty(h.shape[1], dtype=torch.float64, device=h.device)
    _launch_epilogue(hr, h, a, None, res, tol=0.0, stable_sweeps=0,
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


def _spmm_plain_into(op: BsrOperand, x, cin, bs, accum_dtype, mask, out,
                     active=None, scratch=None):
    """``_launch_spmm``'s plain twin: K1 into ``out``, skipped while the
    flag ``active[0]`` is 0 (the CPU rehearsal of the device loop); it
    needs no ``scratch``."""
    if active is None or int(active[0]):
        out.copy_(bsr_scaled_matvec_plain(*op, x, cin, bs=bs,
                                          accum_dtype=accum_dtype, mask=mask))
    return out


def _epilogue_kernel(hr, h, a, st, *, tol, stable_sweeps, max_iter):
    _launch_epilogue(hr, h, a, st, None, tol=tol,
                     stable_sweeps=stable_sweeps, max_iter=max_iter)


# (K1 into out, sweep epilogue, certificate) for the chunked loop
_KERNEL_OPS = (_launch_spmm, _epilogue_kernel, sweep_certificate)
_PLAIN_OPS = (_spmm_plain_into, sweep_epilogue_plain, sweep_certificate_plain)


def _converge_chunked(lt, lf, h0, ca, ch, mask, tol, bs, accum, max_iter,
                      k_eff, stable_sweeps, lt_lo, lf_lo, bulk_tol,
                      bulk_dtype, ops=_KERNEL_OPS):
    """The device loop: per sweep K1, K1 and the epilogue, each predicated
    on the device flag ``ctl[0]``, enqueued ``CHUNK`` sweeps at a time; the
    host reads the flag once per chunk. ``ops`` are the kernels, or their
    plain versions to rehearse the same control flow on the CPU. K1's
    workspace and counters are made once, for every operator of the call."""
    spmm, epilogue, certificate = ops
    counters.bsr_converge += 1
    ctl = torch.zeros(3, dtype=torch.int32, device=h0.device)
    scr = _reserve_k1(Scratch(h0.device),
                      [o for o in (lt, lf, lt_lo, lf_lo) if o is not None],
                      bs, h0.shape[1])

    def loop(lt_op, lf_op, h, cav, chv, mv, stop_tol, acc):
        h = h.contiguous().clone()  # updated in place by the epilogue
        a = torch.empty_like(h)
        hr = torch.empty_like(h)
        st = LoopState.start(ctl, h.shape[1], k_eff, max_iter)
        while True:
            for _ in range(CHUNK):
                spmm(lt_op, h, chv, bs, acc, mv, a, active=ctl, scratch=scr)
                spmm(lf_op, a, cav, bs, acc, mv, hr, active=ctl, scratch=scr)
                epilogue(hr, h, a, st, tol=stop_tol,
                         stable_sweeps=stable_sweeps, max_iter=max_iter)
            counters.host_syncs += 1
            if int(ctl[0]) == 0:
                return h, st.conv

    if bulk_dtype is not None:
        bd = torch_dtype(bulk_dtype)
        h_lo, _ = loop(lt_lo, lf_lo, h0.to(bd), ca.to(bd).contiguous(),
                       ch.to(bd).contiguous(), mask.to(bd).contiguous(),
                       bulk_tol, natural_accum(bd))
        h0 = h_lo.to(h0.dtype)
    h, conv = loop(lt, lf, h0, ca, ch, mask, tol, accum)
    conv = torch.where(conv < 0, ctl[1], conv)
    # certificate: one more full-precision sweep from the published h
    a = spmm(lt, h, ch, bs, accum, mask, torch.empty_like(h), scratch=scr)
    hr = spmm(lf, a, ca, bs, accum, mask, torch.empty_like(h), scratch=scr)
    res = certificate(hr, h, a)
    return h, a, conv, res


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

    CPU tensors run ``bsr_converge_cols_plain``. CUDA tensors run the
    device loop: K1, K1 and the epilogue per sweep, all predicated on the
    device stop flag, enqueued ``CHUNK`` sweeps at a time with one flag
    read per chunk, so ``conv`` equals the per-sweep loop's.
    """
    if bulk_dtype is not None and (lt_lo is None or lf_lo is None):
        raise ValueError("bulk_dtype set but lt_lo/lf_lo operators missing")
    if not h0.is_cuda:
        return bsr_converge_cols_plain(
            lt, lf, h0, ca, ch, mask, tol, bs=bs, accum_dtype=accum_dtype,
            max_iter=max_iter, rank_k=rank_k, stable_sweeps=stable_sweeps,
            lt_lo=lt_lo, lf_lo=lf_lo, bulk_tol=bulk_tol,
            bulk_dtype=bulk_dtype)
    k_eff = min(int(rank_k), h0.shape[0]) if rank_k else 0
    accum = natural_accum(h0.dtype) if accum_dtype is None \
        else torch_dtype(accum_dtype)
    ca, ch, mask = (t.contiguous() for t in (ca, ch, mask))
    return _converge_chunked(lt, lf, h0, ca, ch, mask, float(tol), bs, accum,
                             int(max_iter), k_eff, int(stable_sweeps), lt_lo,
                             lf_lo, float(bulk_tol), bulk_dtype)
