"""Device and dtype resolution shared by every layer of the port.

The JAX package names dtypes as numpy dtypes (``np.dtype("bfloat16")``
exists only through ``ml_dtypes``); the port carries dtype *names*
("float64", "float32", "bfloat16") through its batches and plan keys, so
every hashed key stays byte-equal to the reference's, and maps a name to
a torch dtype only where a tensor is made.
"""
from __future__ import annotations

import numpy as np
import torch

_TORCH = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in _TORCH.items()}


def dtype_name(dtype) -> str:
    """Canonical name of a dtype given as a name, a torch dtype or a numpy
    dtype (or anything ``np.dtype`` accepts)."""
    if isinstance(dtype, torch.dtype):
        name = _NAMES.get(dtype)
    elif isinstance(dtype, str):
        name = dtype if dtype in _TORCH else str(np.dtype(dtype))
    else:
        name = str(np.dtype(dtype))
    if name not in _TORCH:
        raise ValueError(f"unsupported dtype {dtype!r} "
                         f"(want one of {sorted(_TORCH)})")
    return name


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for any spelling ``dtype_name`` accepts."""
    return _TORCH[dtype_name(dtype)]


def host_array(t: torch.Tensor) -> np.ndarray:
    """A host numpy array of ``t``. numpy has no bfloat16 without
    ``ml_dtypes``, so a bf16 tensor comes back as its raw 2-byte patterns
    in a void ``|V2`` array: the bytes the JAX package's ``np.asarray`` of
    a bf16 array writes into an ``.npz``."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def from_host(a) -> torch.Tensor:
    """Inverse of ``host_array``: a CPU tensor of ``a``, where a 2-byte
    void array (or an ``ml_dtypes`` bfloat16 one) holds bf16 patterns."""
    a = np.ascontiguousarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU behind the caller's back)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run on the host")
    return dev


def bind_thread(device) -> None:
    """Make ``device`` the calling thread's current CUDA device (a no-op
    for the CPU). A pipeline or queue thread calls it first, so kernels it
    launches on torch's current stream never depend on which device a new
    thread happens to start on."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)


def tol_in(tol: float, dtype) -> float:
    """``tol`` rounded to ``dtype``. The reference compares a residual with
    its (weakly typed) tolerance in the residual's own dtype, so the
    bf16/f32 bulk phase stops against the rounded tolerance."""
    return float(torch.tensor(float(tol), dtype=torch.float64)
                 .to(torch_dtype(dtype)))
