"""Sharding hints (port of ``repro.models.sharding``).

Models annotate activations with logical specs like ``(DP, None,
"model")`` where DP = ("pod", "data"). In the reference ``shard_hint`` is
a sharding constraint inside a mesh and the identity outside one; the
port runs a model in one process on one device, so it is always the
identity. ``filter_spec`` and ``tree_filter_specs`` come with the
dry-run tools.
"""
from __future__ import annotations

DP = ("pod", "data")  # canonical data-parallel axes (outermost first)


def shard_hint(x, *spec):
    """The identity: the port has no mesh context to constrain ``x`` to."""
    del spec
    return x
