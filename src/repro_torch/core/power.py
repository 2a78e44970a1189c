"""Power-method engine (port of ``repro.core.power``).

Two drivers share one sweep contract ``sweep(v) -> (v_next, aux)`` where
``v_next`` is already L1-normalized; the sweep runs on the device its
tensors lie on.

* ``power_method``     — host loop: records the L1 residual every
  ``check_every`` sweeps (one host read each), and offers the
  extrapolation and checkpoint hooks as plain callables.
* ``power_method_jit`` — the on-device loop: on the card one CUDA graph
  whose WHILE node runs the captured sweeps and a residual kernel that
  sets the loop's condition; no host read until it returns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import tracing
from ..runtime import tol_in


@dataclasses.dataclass
class PowerResult:
    v: np.ndarray                 # primary vector(s), L1-normalized
    aux: Optional[np.ndarray]     # secondary vector(s) (e.g. authority)
    iters: int
    residuals: np.ndarray         # per-recorded-step L1 residuals
    converged: bool


def power_method(
    sweep: Callable,
    v0,
    tol: float = 1e-10,
    max_iter: int = 2000,
    check_every: int = 1,
    extrapolator=None,
    extrapolate_every: int = 0,
    checkpoint_cb: Optional[Callable] = None,
    checkpoint_every: int = 0,
) -> PowerResult:
    """Host-driven power iteration with residual history.

    ``v0``: a tensor on the sweep's device (a numpy array is taken as a
    CPU tensor). ``extrapolator(history)`` gets the last four iterates as
    numpy arrays and returns a replacement iterate or None;
    ``checkpoint_cb(step=, v=, residual=)`` gets numpy too. With
    ``tracing`` on it records ``power.ranking`` around the call,
    ``power.sweep`` and ``power.residual`` each sweep, and
    ``power.readback``.
    """
    with tracing.span("power.ranking"):
        v = v0 if isinstance(v0, torch.Tensor) else torch.from_numpy(
            np.asarray(v0))
        aux = None
        residuals = []
        history = []  # recent iterates for extrapolation
        converged = False
        k = 0
        for k in range(1, max_iter + 1):
            with tracing.span("power.sweep"):
                v_next, aux = sweep(v)
            if k % check_every == 0:
                with tracing.span("power.residual"):
                    delta = float((v_next - v).abs().sum(dim=0).max())
                residuals.append(delta)
                if delta <= tol:
                    v = v_next
                    converged = True
                    break
            v = v_next
            if extrapolator is not None and extrapolate_every:
                history.append(v.cpu().numpy())
                if len(history) > 4:
                    history.pop(0)
                if k % extrapolate_every == 0 and len(history) == 4:
                    v_x = extrapolator(history)
                    if v_x is not None:
                        v = torch.as_tensor(np.asarray(v_x)).to(v.device)
                        history.clear()
            if checkpoint_cb is not None and checkpoint_every \
                    and k % checkpoint_every == 0:
                checkpoint_cb(step=k, v=v.cpu().numpy(),
                              residual=residuals[-1] if residuals else np.inf)
        with tracing.span("power.readback"):
            return PowerResult(
                v=v.cpu().numpy(),
                aux=None if aux is None else aux.cpu().numpy(),
                iters=k,
                residuals=np.asarray(residuals),
                converged=converged,
            )


def power_method_jit(sweep: Callable, v0, tol: float = 1e-10,
                     max_iter: int = 2000, check_every: int = 1):
    """On-device while-loop power iteration (the reference's
    ``lax.while_loop``).

    The residual max_j ‖v − v_prev‖₁ (v_prev: the iterate ``check_every``
    sweeps earlier) is evaluated every ``check_every`` sweeps; the loop
    runs while k < max_iter and residual > tol, tested before the first
    chunk (max_iter 0 runs no sweep). Returns (v, aux, iters, delta) as
    tensors on v0's device: aux is the last sweep's (zeros if none ran),
    iters an int64 scalar, delta the last residual in v's dtype (inf if
    none was taken).

    On the CPU it is a plain loop. On the card it reuses the
    conditional-node design of K2's graph (``kernels.bsr_spmm``): the
    chunk ``v_prev = v``, then ``check_every`` times ``v = sweep(v)``, is
    captured with ``torch.cuda.CUDAGraph(keep_graph=True)`` (one warm-up
    sweep on a copy first, outside the capture), and
    ``kernels.bsr_spmm.PowerGraph`` makes it the body of a WHILE node,
    followed by a residual kernel that updates k and the condition. The
    call builds, launches, waits for and destroys its graph. A sweep that
    cannot be captured (one that reads the device from the host, or
    synchronizes) raises: ``torch.segment_reduce`` checks its lengths on
    the host, so the segment-sum sweeps (``core.hits.hits_sweep`` over an
    ``EdgeList``, ``pagerank``) run under ``power_method`` only; the K1
    sweep of ``kernels.ops.hits_sweep_bsr`` captures. Kernel launches
    inside the graph are counted once, at the capture.
    """
    v = (v0 if isinstance(v0, torch.Tensor)
         else torch.from_numpy(np.asarray(v0))).clone(
        memory_format=torch.contiguous_format)
    check_every = int(check_every)
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, not {check_every}")
    if not v.is_cuda:
        aux = torch.zeros_like(v)
        k, delta = 0, float("inf")
        stop_tol = tol_in(tol, v.dtype)
        while k < max_iter and delta > stop_tol:
            v_prev = v
            for _ in range(check_every):
                v, aux = sweep(v)
            delta = float((v - v_prev).abs().sum(dim=0).max())
            k += check_every
        return (v, aux, torch.tensor(k, dtype=torch.int64),
                torch.tensor(delta, dtype=v.dtype))
    from ..kernels.bsr_spmm import PowerGraph
    dev = v.device
    aux = torch.zeros_like(v)
    v_prev = torch.empty_like(v)
    k = torch.zeros((), dtype=torch.int64, device=dev)
    delta = torch.zeros((), dtype=torch.float64, device=dev)
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    with torch.cuda.stream(side):  # lazy initialisations, outside the capture
        sweep(v.clone())
    cur.wait_stream(side)
    captured = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(captured):
            v_prev.copy_(v)
            for _ in range(check_every):
                v_next, a = sweep(v)
                v.copy_(v_next)
            aux.copy_(a)
    except RuntimeError as e:
        raise RuntimeError("power_method_jit: the sweep cannot be captured "
                           "in a CUDA graph (it must not read the device "
                           "from the host or synchronize)") from e
    graph = PowerGraph(captured.raw_cuda_graph(), v, v_prev, k, delta,
                       check_every=check_every, max_iter=max_iter, tol=tol)
    try:
        graph.launch()
        cur.synchronize()  # the graph and the captured pool end together
    finally:
        graph.destroy()
        del captured
    return v, aux, k, delta.to(v.dtype)
