"""Power-method engine (port of ``repro.core.power``).

``power_method`` drives a sweep ``sweep(v) -> (v_next, aux)``, where
``v_next`` is already L1-normalized, from the host: it records the L1
residual every ``check_every`` sweeps (one host read each), and offers the
extrapolation and checkpoint hooks as plain callables. The sweep runs on
the device its tensors lie on. The reference's on-device
``power_method_jit`` is not ported yet (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass
class PowerResult:
    v: np.ndarray                 # primary vector(s), L1-normalized
    aux: Optional[np.ndarray]     # secondary vector(s) (e.g. authority)
    iters: int
    residuals: np.ndarray         # per-recorded-step L1 residuals
    converged: bool
    sweeps_flops: int = 0         # filled by callers that track cost


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
    ``checkpoint_cb(step=, v=, residual=)`` gets numpy too.
    """
    v = v0 if isinstance(v0, torch.Tensor) else torch.from_numpy(
        np.asarray(v0))
    aux = None
    residuals = []
    history = []  # recent iterates for extrapolation
    converged = False
    k = 0
    for k in range(1, max_iter + 1):
        v_next, aux = sweep(v)
        if k % check_every == 0:
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
    return PowerResult(
        v=v.cpu().numpy(),
        aux=None if aux is None else aux.cpu().numpy(),
        iters=k,
        residuals=np.asarray(residuals),
        converged=converged,
    )
