"""Production mesh builders (port of ``repro.launch.mesh``). Functions,
not module constants, so importing touches no device.

A mesh is a ``sparse.dist.Mesh``: the production meshes hold logical
``meta`` devices (the dry-run places nothing on a device; its model
cells run on a fake process group of the mesh's size), the host mesh
covers the visible devices of one type."""
from __future__ import annotations

from ..sparse.dist import Mesh, visible_devices


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 (=256 chips/pod) single-pod, or 2x16x16 (=512 chips) multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    return Mesh(("meta",) * n, shape, axes)


def make_host_mesh(model: int = 1, device="cuda") -> Mesh:
    """A (data, model) mesh over the visible devices of ``device``'s type
    (one host, every card; the CPU is one device)."""
    devs = visible_devices(device)
    if not devs:
        raise RuntimeError(f"no visible {device} device")
    return Mesh(devs, (len(devs) // model, model), ("data", "model"))
