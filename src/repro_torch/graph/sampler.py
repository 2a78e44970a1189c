"""Neighbor sampling for minibatch GNN training (GraphSAGE-style fanout;
port of ``repro.graph.sampler``).

A fanout sampler over a padded neighbor table on the device: for each
seed node it draws ``fanout`` neighbors uniformly (with replacement, as
GraphSAGE does when degree < fanout). Output shapes depend only on the
seed count and the fanouts, so a sampled subgraph feeds the same train
step every time.

Draws come from an explicit ``torch.Generator`` (on the table's device),
or are passed in: the reference draws ``jax.random.randint(key, (B,
fanout), 0, 2**31 - 1)`` per layer, whose bits torch cannot make, so its
tests hand the port those draws (``draws=``). The message edges of a
sample (child -> parent, local ids) are the same for every sample of one
seed count and fanouts, so a sample carries them with the aggregation's
layouts of them (``kernels.ops.EdgeLayouts``), and a later sample made
``like=`` it reuses both: a training loop builds them once.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional, Sequence

import numpy as np
import torch

from ..runtime import resolve_device
from .structure import Graph, padded_neighbors

if TYPE_CHECKING:  # kernels.ops imports this package
    from ..kernels.ops import EdgeLayouts


@dataclasses.dataclass(frozen=True)
class SamplerTables:
    """Device-resident neighbor table."""

    nbr: torch.Tensor  # (N, max_deg) int32
    deg: torch.Tensor  # (N,) int32

    @staticmethod
    def build(g: Graph, max_deg: int, device="cuda") -> "SamplerTables":
        tbl, deg = padded_neighbors(g, max_deg)
        dev = resolve_device(device)
        return SamplerTables(torch.from_numpy(tbl).to(dev),
                             torch.from_numpy(deg).to(dev))


def sample_layer(tables: SamplerTables, seeds: torch.Tensor, fanout: int, *,
                 generator: Optional[torch.Generator] = None,
                 draws: Optional[torch.Tensor] = None):
    """Sample ``fanout`` out-neighbors per seed.

    ``draws``: (B, fanout) integers in [0, 2**31 - 1), else drawn from
    ``generator``. Returns (neighbors (B, fanout) int32, mask (B, fanout)
    bool). Zero-degree seeds yield themselves with mask=False.
    """
    seeds = seeds.to(tables.nbr.device, torch.long)
    deg = tables.deg[seeds]                                   # (B,)
    if draws is None:
        draws = torch.randint(0, 2 ** 31 - 1, (seeds.shape[0], fanout),
                              generator=generator, device=seeds.device)
    r = draws.to(seeds.device, torch.long)
    idx = r % torch.clamp(deg, min=1).long()[:, None]         # (B, fanout)
    nbrs = tables.nbr[seeds[:, None], idx]
    mask = deg[:, None] > 0
    nbrs = torch.where(mask, nbrs, seeds[:, None].to(nbrs.dtype))
    return nbrs, mask.expand(nbrs.shape)


@dataclasses.dataclass(frozen=True)
class SampledSubgraph:
    """Fixed-shape k-hop sampled block used by the minibatch GIN step.

    nodes: (n_total,) node ids, seeds first. edge_src/edge_dst index into
    ``nodes`` (local ids). edge_mask marks real edges. lay: the
    aggregation's layouts of (edge_src, edge_dst) over n_total nodes.
    """

    nodes: torch.Tensor
    edge_src: torch.Tensor
    edge_dst: torch.Tensor
    edge_mask: torch.Tensor
    n_seeds: int
    lay: EdgeLayouts


def _khop_edges(n_seeds: int, fanouts: Sequence[int], device):
    """(edge_src, edge_dst) of a k-hop sample, on ``device``."""
    srcs, dsts = [], []
    b, offset, frontier_off = n_seeds, n_seeds, 0
    for f in fanouts:
        srcs.append(np.arange(b * f, dtype=np.int32) + offset)
        dsts.append(np.repeat(np.arange(b, dtype=np.int32) + frontier_off,
                              f))
        frontier_off = offset
        offset += b * f
        b *= f
    return tuple(torch.from_numpy(np.concatenate(x)).to(device)
                 for x in (srcs, dsts))


def sample_khop(tables: SamplerTables, seeds: torch.Tensor,
                fanouts: Sequence[int], *,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Sequence[torch.Tensor]] = None,
                like: Optional[SampledSubgraph] = None) -> SampledSubgraph:
    """Multi-layer fanout sampling (e.g. fanouts=(15, 10)).

    Layout: nodes = [seeds, hop1 samples, hop2 samples, ...]; each sampled
    neighbor contributes a (neighbor -> parent) message edge, matching
    aggregation direction in GraphSAGE/GIN minibatch training. ``draws``:
    one tensor per layer (see ``sample_layer``). ``like``: an earlier
    sample of the same seed count and fanouts on the same device, whose
    edges and layouts this one shares instead of building its own.
    """
    dev = tables.nbr.device
    seeds = seeds.to(dev)
    frontier = seeds
    all_nodes = [seeds.to(torch.int32)]
    masks = []
    for li, f in enumerate(fanouts):
        nbrs, mask = sample_layer(tables, frontier, f, generator=generator,
                                  draws=None if draws is None else draws[li])
        masks.append(mask.reshape(-1))
        all_nodes.append(nbrs.reshape(-1))
        frontier = nbrs.reshape(-1)
    nodes = torch.cat(all_nodes)
    if like is None:
        from ..kernels.ops import EdgeLayouts
        src, dst = _khop_edges(seeds.shape[0], fanouts, dev)
        lay = EdgeLayouts.build(src, dst, nodes.shape[0])
    else:
        if (like.n_seeds, like.nodes.shape, like.nodes.device) != (
                seeds.shape[0], nodes.shape, nodes.device):
            raise ValueError("like= is a sample of another shape or device")
        src, dst, lay = like.edge_src, like.edge_dst, like.lay
    return SampledSubgraph(nodes=nodes, edge_src=src, edge_dst=dst,
                           edge_mask=torch.cat(masks),
                           n_seeds=int(seeds.shape[0]), lay=lay)


def khop_sizes(n_seeds: int, fanouts: tuple):
    """Static (n_nodes_total, n_edges_total) of a k-hop sample."""
    n, e, b = n_seeds, 0, n_seeds
    for f in fanouts:
        e += b * f
        b = b * f
        n += b
    return n, e
