"""Sharding hints and logical PartitionSpecs (port of
``repro.models.sharding``).

Models annotate activations with logical specs like ``(DP, None,
"model")`` where DP = ("pod", "data"). ``P`` is the port's
PartitionSpec: one entry per tensor axis, each ``None``, a mesh axis
name or a tuple of names (outermost first). ``filter_spec`` drops the
axes a mesh does not have (a single-pod mesh has no "pod"), so the same
specs serve every mesh.

``shard_hint`` is the identity on a plain tensor: the port runs a model
in one process. On a ``DTensor`` (the dry-run's sharded step,
``launch/dryrun.py``) it redistributes to the hinted spec, as the
reference's ``with_sharding_constraint`` does inside a mesh;
``shard_like`` gives a gradient its parameter's placements. These are
the dry-run's explicit redistributions, which it counts itself
(``REDISTRIBUTE``); it refuses any that DTensor would choose.
``remat_context`` tells the dry-run where a checkpointed layer's
recompute begins (``RECOMPUTE``); outside it, it is the checkpoint's own
``context_fn``.
"""
from __future__ import annotations

import contextlib
import sys

DP = ("pod", "data")  # canonical data-parallel axes (outermost first)


class P:
    """A PartitionSpec: ``P(DP, None, "model")``. A leaf of the port's
    trees (not a tuple, which ``tree.walk`` would enter); iterates,
    indexes and compares as the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(tuple(e) if isinstance(e, list) else e
                             for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        return isinstance(other, P) and self.entries == other.entries

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"P{self.entries!r}" if len(self.entries) != 1 else \
            f"P({self.entries[0]!r})"


def _filter_axis(a, names):
    if a is None:
        return None
    if isinstance(a, (tuple, list)):
        kept = tuple(x for x in a if x in names)
        return kept if len(kept) > 1 else (kept[0] if kept else None)
    return a if a in names else None


def _axis_names(mesh):
    """A port ``Mesh``'s ``axes`` or a ``DeviceMesh``'s dim names."""
    names = getattr(mesh, "axes", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def filter_spec(spec, mesh) -> P:
    """Concretize a logical PartitionSpec against a mesh (drop absent axes)."""
    names = set(_axis_names(mesh))
    return P(*tuple(_filter_axis(a, names) for a in spec))


def tree_filter_specs(tree, mesh):
    """``filter_spec`` over every ``P`` leaf of a tree."""
    from ..tree import tree_map
    return tree_map(lambda s: filter_spec(s, mesh), tree)


def axis_of(mesh_dim_name: str) -> str:
    """The mesh axis a ``DeviceMesh`` dim belongs to: the dry-run may
    factor an axis into consecutive dims named ``axis``, ``axis.1``, ...
    (outermost first), which together shard what the axis shards."""
    return mesh_dim_name.partition(".")[0]


def placements(spec, device_mesh):
    """The DTensor placements of a filtered spec on ``device_mesh``: per
    mesh dim, ``Shard(i)`` for the tensor axis whose entry names its
    axis, else ``Replicate()``. Axes in one entry shard that tensor axis
    in mesh order (the outermost first, as in the reference)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in map(axis_of, device_mesh.mesh_dim_names):
        dim = next((i for i, a in enumerate(spec)
                    if a == name or (isinstance(a, tuple) and name in a)),
                   None)
        out.append(Replicate() if dim is None else Shard(dim))
    return out


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (the dry-run's sharded step)."""
    dt = sys.modules.get("torch.distributed.tensor")  # loaded if x is one
    return dt is not None and isinstance(x, dt.DTensor)


def shard_hint(x, *spec):
    """The identity on a plain tensor; a ``DTensor`` is redistributed to
    ``spec`` (filtered against its mesh). An axis whose mesh size does
    not divide the dim still shards it, unevenly (``torch.chunk``'s
    shards, the last one short), as XLA keeps such a constraint and pads
    each shard to ceil(n / k)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = filter_spec(spec, mesh)
    spec = P(*(a if i < x.dim() else None for i, a in enumerate(spec)))
    return _redistribute(x, placements(spec, mesh))


def shard_like(x, like):
    """The identity on a plain tensor; a ``DTensor`` is redistributed to
    ``like``'s placements (a gradient to its parameter's)."""
    if not is_dtensor(x):
        return x
    return _redistribute(x, list(like.placements))


# the dry-run's own redistribution while it runs (``launch/dryrun.py``
# sets it: it counts the collectives itself, the same on every torch)
REDISTRIBUTE = None


def _redistribute(x, want):
    if list(x.placements) == list(want):
        return x
    if REDISTRIBUTE is not None:
        return REDISTRIBUTE(x, want)
    return x.redistribute(x.device_mesh, want)


# the dry-run's hook while it runs (``launch/dryrun.py`` sets it): a
# context manager factory, entered where a checkpointed layer's recompute
# begins (its weights gathered once for the recompute and the backward)
RECOMPUTE = None


def remat_context(context_fn=None):
    """``checkpoint``'s ``context_fn``: ``context_fn`` itself (a selective
    policy's contexts; None: checkpoint's default, none) outside the
    dry-run; inside it, ``context_fn``'s contexts with ``RECOMPUTE``'s
    entered around the recompute too."""
    if context_fn is None:
        from torch.utils.checkpoint import noop_context_fn
        context_fn = noop_context_fn
    hook = RECOMPUTE
    if hook is None:
        return context_fn

    def contexts():
        fwd, rec = context_fn()
        return fwd, _both(rec, hook())
    return contexts


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield
