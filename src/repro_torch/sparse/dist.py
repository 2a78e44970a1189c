"""Distributed HITS/ranking sweeps over a mesh of devices (port of
``repro.sparse.dist``).

Edge-sharding strategies with different collective costs per sweep
(per-device bytes, vector length N, S shards):

* ``replicated``   — edges round-robin sharded; both half-steps end in a
                     full-vector psum (all-reduce). Cost ≈ 4N.
* ``dual_blocked`` — two edge partitions (by dst block for the authority
                     step, by src block for the hub step); both half-steps
                     scatter only into the owner's block, combine = 2
                     all-gathers. Cost ≈ 2N.

**One process over a tuple of devices.** The reference is one controller
over a ``jax.sharding.Mesh``: ``shard_map`` runs the shard body on every
device of the mesh and ``lax.psum``/``all_gather`` combine the results.
Here ``Mesh`` is a tuple of torch devices (``make_mesh`` places shard s on
the (s % k)-th of the k visible devices of a type: every shard is "cpu" on
the host), the shard body is a Python loop over shards whose tensors live
on their shard's device, and the collectives are plain functions over
per-shard lists. A *replicated* value is a list holding one tensor per
shard (shards on one device share it); a *blocked* value holds shard s's
block at index s. Copies between distinct cards are ``.to(dev,
non_blocking=True)``, which torch orders with events on both cards'
current streams.

The collectives add exactly what XLA's CPU collectives do, in the same
order: ``psum`` folds the shards in order 0…S-1 (bf16 parts in f32,
rounded once), as a probe of ``lax.psum`` over 8 forced host devices
shows; each shard's segment sum adds its edges in edge order (a stable
sort by scatter index, made once per layout). Each collective adds its
per-device output bytes, by kind, to ``Mesh.collective_bytes``, which is
what ``launch.hlo_analysis.collective_bytes`` reads from the reference's
HLO; ``Mesh.segment_sums`` counts the shard segment sums (on the card
each one reads its lengths on the host). Each collective and segment sum
runs inside a ``torch.profiler.record_function`` range (``dist.psum``,
``dist.pmax``, ``dist.all_gather``, ``dist.ppermute``, ``dist.segment_sum``), so a
profiler trace splits the device time between them.

``make_dryrun_rank_sweep`` is not here: it stays with its only caller,
``launch/dryrun.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..graph.partition import partition_edges, partition_edges_by_dst_block
from ..graph.structure import Graph, next_pow2
from ..runtime import from_host, torch_dtype
from .spmv import SegmentLayout, segment_layout, segment_sum


class Mesh:
    """S shards, row-major over ``shape`` (axis names ``axes``): shard s
    is the reference's flat axis index s (``_flat_axis_index``) and lives
    on ``devices[s]``. Holds the collective counters."""

    def __init__(self, devices: Sequence, shape=None,
                 axes: Sequence[str] = ("data",)):
        self.devices = tuple(torch.device(d) for d in devices)
        self.shape = tuple(shape) if shape is not None else (len(devices),)
        self.axes = tuple(axes)
        if int(np.prod(self.shape)) != len(self.devices) or \
                len(self.shape) != len(self.axes):
            raise ValueError(f"mesh shape {self.shape} over axes {self.axes}"
                             f" does not hold {len(self.devices)} devices")
        self.collective_bytes: Dict[str, int] = {}
        self.collective_ops = 0
        self.segment_sums = 0

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct_devices(self):
        return tuple(dict.fromkeys(self.devices))

    def reset_counters(self):
        self.collective_bytes = {}
        self.collective_ops = 0
        self.segment_sums = 0

    def _count(self, kind: str, t: torch.Tensor):
        self.collective_bytes[kind] = (self.collective_bytes.get(kind, 0)
                                       + t.numel() * t.element_size())
        self.collective_ops += 1

    def replicate(self, t: torch.Tensor):
        """``t`` on every shard's device (one copy per distinct device)."""
        on = {d: _to(t, d) for d in self.distinct_devices()}
        return [on[d] for d in self.devices]

    def shard_rows(self, t: torch.Tensor):
        """An (S, ...) host or device tensor's row s on shard s's device."""
        if t.shape[0] != self.size:
            raise ValueError(f"{tuple(t.shape)} has no row per shard of "
                             f"{self.size}")
        return [_to(b, d) for b, d in zip(t.unbind(0), self.devices)]

    def __repr__(self):
        return (f"Mesh({[str(d) for d in self.devices]}, shape={self.shape}, "
                f"axes={self.axes})")


def visible_devices(device) -> list:
    """The visible devices of ``device``'s type: the host for "cpu", every
    card for "cuda"."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")]
    return [torch.device(dev.type, i)
            for i in range(torch.cuda.device_count())]


def round_robin(n: int, device) -> list:
    """Devices for n shards: shard s on the (s % k)-th of the k visible
    devices of ``device``'s type. On one card (or the host) every shard
    shares it: logical shards, the counterpart of XLA's forced host device
    count."""
    vis = visible_devices(device)
    if not vis:
        raise RuntimeError(f"no visible {torch.device(device).type} device")
    return [vis[s % len(vis)] for s in range(n)]


def make_mesh(shape, axes: Sequence[str] = ("data",), device="cuda") -> Mesh:
    """A mesh of ``prod(shape)`` shards placed by ``round_robin``."""
    shape = (int(shape),) if np.isscalar(shape) else tuple(shape)
    return Mesh(round_robin(int(np.prod(shape)), device), shape, axes)


def _to(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    return t if t.device == dev else t.to(dev, non_blocking=True)


# ------------------------------------------------------------ collectives


def psum(mesh: Mesh, parts):
    """All-reduce: the shards' parts added in shard order 0…S-1 (bf16 in
    f32, rounded once, as XLA's CPU all-reduce does), the sum placed on
    every shard's device."""
    with record_function("dist.psum"):
        home = parts[0].device
        low = parts[0].dtype == torch.bfloat16
        acc = parts[0].float() if low else parts[0]
        for p in parts[1:]:
            p = _to(p, home)
            acc = acc + (p.float() if low else p)
        if low:
            acc = acc.to(torch.bfloat16)
        mesh._count("all-reduce", acc)
        return mesh.replicate(acc)


def pmax(mesh: Mesh, parts):
    """All-reduce by max: the shards' parts' elementwise max (exact in any
    order), placed on every shard's device. Counted as an all-reduce, the
    collective XLA lowers ``lax.pmax`` to."""
    with record_function("dist.pmax"):
        home = parts[0].device
        acc = parts[0]
        for p in parts[1:]:
            acc = torch.maximum(acc, _to(p, home))
        mesh._count("all-reduce", acc)
        return mesh.replicate(acc)


def all_gather(mesh: Mesh, blocks):
    """Tiled all-gather: the blocks concatenated in shard order on every
    shard's device."""
    with record_function("dist.all_gather"):
        home = blocks[0].device
        full = torch.cat([_to(b, home) for b in blocks])
        mesh._count("all-gather", full)
        return mesh.replicate(full)


def ppermute(mesh: Mesh, parts):
    """Collective permute one step along the ring: shard d receives shard
    (d - 1) % S's part, as a copy on its own device."""
    s = mesh.size
    with record_function("dist.ppermute"):
        out = [parts[(d - 1) % s].to(mesh.devices[d], non_blocking=True,
                                     copy=True) for d in range(s)]
    mesh._count("collective-permute", parts[0])
    return out


def ring_allreduce_chunked(mesh: Mesh, parts, n_chunks: int = 4):
    """Ring all-reduce: reduce-scatter by S-1 ``ppermute`` steps, then an
    all-gather, in ``n_chunks`` row chunks. The same sum as ``psum`` (in
    another order)."""
    s = mesh.size
    if s == 1:
        return list(parts)
    rows, rest = parts[0].shape[0], tuple(parts[0].shape[1:])
    pad = (-rows) % (n_chunks * s)
    xp = [torch.cat([p, p.new_zeros((pad,) + rest)]) for p in parts]
    per = xp[0].shape[0] // n_chunks
    outs = [[] for _ in range(s)]
    for k in range(n_chunks):
        bufs = [x[k * per:(k + 1) * per].reshape((s, -1) + rest).clone()
                for x in xp]
        for t in range(s - 1):
            recv = ppermute(mesh, [bufs[d][(d - t) % s] for d in range(s)])
            for d in range(s):
                bufs[d][(d - t - 1) % s] += recv[d]
        # shard d now holds the reduced piece (d + 1) % s
        gathered = all_gather(mesh, [bufs[d][(d + 1) % s][None]
                                     for d in range(s)])
        for d in range(s):
            outs[d].append(torch.roll(gathered[d], 1, 0)
                           .reshape((per,) + rest))
    return [torch.cat(o)[:rows] for o in outs]


def _seg(mesh: Mesh, x, layout: SegmentLayout):
    mesh.segment_sums += 1
    with record_function("dist.segment_sum"):
        return segment_sum(x, layout)


def live_layout(gather, target, n: int, w) -> SegmentLayout:
    """``spmv.segment_layout`` over the edges that add something: targets
    in [0, n) (the reference's ``segment_sum`` drops the rest) with a
    nonzero weight. A zero-weight padding edge adds an exact zero, so
    leaving it out changes no bit of a finite sum; left in, a shard's
    padding would all land in one segment (the dead pad row, or the
    block start), which ``segment_reduce`` on the card adds serially."""
    target = torch.as_tensor(target).long()
    keep = (target >= 0) & (target < n) & (w != 0)
    if not bool(keep.all()):
        gather, target, w = gather[keep], target[keep], w[keep]
    return segment_layout(gather, target, n, w)


# ------------------------------------------------------ whole-graph sweep


def build_edge_shards(g: Graph, n_shards: int, mode: str = "replicated"):
    """Host-side partition. Returns dict of (S, E_loc) arrays (+ metadata)."""
    if mode == "replicated":
        parts = partition_edges(g, n_shards)
        parts["mode"] = "replicated"
        return parts
    if mode == "dual_blocked":
        a_part = partition_edges_by_dst_block(g, n_shards)
        h_part = partition_edges_by_dst_block(g.reverse(), n_shards)
        # reverse() swaps src/dst: h_part's "dst" is the original src, so the
        # hub step scatters block-locally.
        return {"mode": "dual_blocked", "a": a_part, "h": h_part,
                "n_block": a_part["n_block"]}
    if mode == "dual_blocked_compact":
        # hub vectors live in the reordered non-dangling space (dangling
        # pages have zero hub score — never ship them)
        dang = g.dangling_mask()
        nd_ids = np.nonzero(~dang)[0].astype(np.int32)
        remap = np.full(g.n_nodes, -1, np.int32)
        remap[nd_ids] = np.arange(len(nd_ids), dtype=np.int32)
        src_c = remap[g.src]
        assert (src_c >= 0).all()
        a_part = partition_edges_by_dst_block(
            Graph(g.n_nodes, src_c, g.dst), n_shards)  # src in compact space
        h_part = partition_edges_by_dst_block(
            Graph(len(nd_ids), g.dst, src_c), n_shards)  # blocked by src_c
        return {"mode": "dual_blocked_compact", "a": a_part, "h": h_part,
                "n_block": a_part["n_block"], "nb_h": h_part["n_block"],
                "nd_ids": nd_ids, "n_hub": len(nd_ids)}
    raise ValueError(mode)


def _part_layouts(mesh: Mesh, part, n_seg: int, block: int, scatter="dst"):
    """Per shard, the layout of one partition: gather at the other
    endpoint, scatter at ``scatter`` minus the shard's block start, weight
    w * mask (float32, as the reference promotes)."""
    gather = "src" if scatter == "dst" else "dst"
    out = []
    for s, dev in enumerate(mesh.devices):
        wm = (torch.from_numpy(np.asarray(part["w"][s], np.float32))
              * torch.from_numpy(np.asarray(part["mask"][s])))
        out.append(live_layout(
            torch.from_numpy(np.asarray(part[gather][s], np.int64)).to(dev),
            torch.from_numpy(np.asarray(part[scatter][s], np.int64)
                             - s * block).to(dev), n_seg, wm.to(dev)))
    return out


def make_dist_hits_sweep(mesh: Mesh, shards, n: int,
                         ca: Optional[np.ndarray] = None,
                         ch: Optional[np.ndarray] = None,
                         dtype="float32"):
    """Return (sweep_fn, h0, args) for the given strategy, the edges
    sharded over every shard of the mesh (the reference's ``axes`` naming
    all of its axes).

    ``sweep_fn(h, *args) -> (h_next_normalized, a)``. ``h`` is replicated
    (a per-shard list) in ``replicated`` mode and blocked (shard s's block
    at s) otherwise; ``args`` holds each shard's edge layouts.
    """
    mode = shards["mode"]
    s_n = mesh.size
    dt = torch_dtype(dtype)
    home = mesh.devices[0]

    def diag(c):
        return None if c is None else mesh.replicate(
            torch.as_tensor(np.asarray(c)).to(home, dt))

    ca_r, ch_r = diag(ca), diag(ch)

    def mul(x, c, s):
        return x if c is None else x * c[s]

    if mode == "replicated":
        lay_a = _part_layouts(mesh, shards, n, 0, "dst")
        lay_h = _part_layouts(mesh, shards, n, 0, "src")

        def sweep(h, layouts):
            la, lh = layouts
            a = psum(mesh, [_seg(mesh, mul(h[s], ch_r, s), la[s])
                            for s in range(s_n)])
            h_new = psum(mesh, [_seg(mesh, mul(a[s], ca_r, s), lh[s])
                                for s in range(s_n)])
            h_new = [x / (x.abs().sum(dim=0, keepdim=x.dim() > 1) + 1e-30)
                     for x in h_new]
            return h_new, a

        h0 = mesh.replicate(torch.full((n,), 1.0 / n, dtype=dt, device=home))
        return sweep, h0, ((lay_a, lay_h),)

    if mode in ("dual_blocked", "dual_blocked_compact"):
        compact = mode == "dual_blocked_compact"
        nb_a = int(shards["n_block"])
        nb_h = int(shards["nb_h"]) if compact else nb_a
        n_hub = int(shards["n_hub"]) if compact else n
        if compact and ch is not None:
            ch_r = diag(np.asarray(ch)[shards["nd_ids"]])
        lay_a = _part_layouts(mesh, shards["a"], nb_a, nb_a, "dst")
        lay_h = _part_layouts(mesh, shards["h"], nb_h, nb_h, "dst")

        def sweep(h_blk, layouts):
            la, lh = layouts
            h_full = all_gather(mesh, h_blk)
            a_blk = [_seg(mesh, mul(h_full[s][:n_hub], ch_r, s), la[s])
                     for s in range(s_n)]
            a_full = all_gather(mesh, a_blk)
            h_new = [_seg(mesh, mul(a_full[s][:n], ca_r, s), lh[s])
                     for s in range(s_n)]
            tot = psum(mesh, [x.abs().sum() for x in h_new])
            return [x / (t + 1e-30) for x, t in zip(h_new, tot)], a_blk

        h0 = [torch.full((nb_h,), 1.0 / n, dtype=dt, device=d)
              for d in mesh.devices]
        return sweep, h0, ((lay_a, lay_h),)

    raise ValueError(f"unsupported mode {mode}")


def blocked_to_full(h_blk, n: int) -> np.ndarray:
    """Blocked hub vector (shard s's block at s) -> (N,) host array."""
    return torch.cat([b.cpu() for b in h_blk]).numpy()[:n]


# ------------------------------------------------------------- serve path
#
# The serving column sweep (core.hits.hits_sweep_cols) distributes the same
# way, with vectors (N, V) and the per-column weights/masks as runtime
# arguments.


def build_edge_shards_cols(src, dst, w, n_pad: int, n_shards: int,
                           mode: str = "replicated"):
    """Edge shards for the padded union-subgraph column sweep.

    Per-shard edge lengths pad to the next power of two. Sentinel edges
    carry w=0 and point at rows whose weights are identically zero, so
    they contribute nothing to either half-step. (The reference's function,
    pure numpy: the same arrays.)
    """
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = np.asarray(w)
    # strip sentinel (w=0) padding edges up front: under dual_blocked they
    # would all land in the dead pad row's shard and inflate every shard's
    # bucket
    keep = w != 0
    if not keep.all():
        src, dst, w = src[keep], dst[keep], w[keep]
    e = len(src)

    if mode == "replicated":
        chunk = -(-e // n_shards) if e else 1
        per = next_pow2(chunk)
        s_a = np.full((n_shards, per), n_pad - 1, np.int32)
        d_a = np.full((n_shards, per), n_pad - 1, np.int32)
        w_a = np.zeros((n_shards, per), w.dtype)
        for s in range(n_shards):
            sel = slice(s * chunk, min((s + 1) * chunk, e))
            c = max(sel.stop - sel.start, 0)
            s_a[s, :c] = src[sel]
            d_a[s, :c] = dst[sel]
            w_a[s, :c] = w[sel]
        return {"mode": "replicated", "src": s_a, "dst": d_a, "w": w_a,
                "per": per}

    if mode == "dual_blocked":
        nb = -(-n_pad // n_shards)

        def blocked(key):
            shard_of = key // nb
            order = np.argsort(shard_of, kind="stable")
            counts = np.bincount(shard_of, minlength=n_shards)[:n_shards]
            return order, counts

        a_order, a_counts = blocked(dst)
        h_order, h_counts = blocked(src)
        per = next_pow2(max(int(a_counts.max(initial=1)),
                             int(h_counts.max(initial=1)), 1))

        def pack(order, counts, gather_ids, scatter_ids):
            # scatter ids stay inside the shard's own block; sentinel
            # scatter = block start, sentinel gather = the dead pad row
            g = np.full((n_shards, per), n_pad - 1, np.int32)
            sc = np.zeros((n_shards, per), np.int32)
            ww = np.zeros((n_shards, per), w.dtype)
            start = 0
            for s in range(n_shards):
                c = int(counts[s])
                sel = order[start:start + c]
                g[s, :c] = gather_ids[sel]
                sc[s, :c] = scatter_ids[sel]
                sc[s, c:] = s * nb
                ww[s, :c] = w[sel]
                start += c
            return {"src": g, "dst": sc, "w": ww}

        return {"mode": "dual_blocked", "nb": nb, "per": per,
                "a": pack(a_order, a_counts, src, dst),   # gather h at src
                "h": pack(h_order, h_counts, dst, src)}   # gather a at dst

    raise ValueError(mode)


def device_put_edge_args_cols(shards, dtype, mesh: Mesh):
    """Ship ``build_edge_shards_cols`` output to the mesh as the sweep's
    edge arguments, in the reference's calling-convention order ((src,
    dst, w) for ``replicated``; (asrc, adst, aw, hsrc, hdst, hw) for
    ``dual_blocked``): per argument, a tuple of the S per-shard rows,
    each on its shard's device (int32 endpoints, w at ``dtype``)."""
    if shards["mode"] == "replicated":
        parts = (shards,)
    elif shards["mode"] == "dual_blocked":
        parts = (shards["a"], shards["h"])
    else:
        raise ValueError(shards["mode"])
    dt = torch_dtype(dtype)
    eargs = ()
    for part in parts:
        eargs += (tuple(mesh.shard_rows(from_host(part["src"]))),
                  tuple(mesh.shard_rows(from_host(part["dst"]))),
                  tuple(mesh.shard_rows(from_host(part["w"]).to(dt))))
    return eargs


def edge_layouts_cols(mesh: Mesh, mode: str, eargs, n_pad: int):
    """Per shard, the (authority, hub) segment layouts of the edge
    arguments: each half-step's nonzero-weight edges stably sorted by
    scatter index (edge order kept within a segment, as XLA's scatter adds
    them; the zero-weight padding left out, see ``live_layout``). Structure
    only, made once per plan on the shards' devices."""
    out = []
    if mode == "replicated":
        for src, dst, w in zip(*eargs):
            out.append((live_layout(src, dst, n_pad, w),
                        live_layout(dst, src, n_pad, w)))
        return tuple(out)
    nb = -(-n_pad // mesh.size)
    for s, (asrc, adst, aw, hsrc, hdst, hw) in enumerate(zip(*eargs)):
        out.append((live_layout(asrc, adst.long() - s * nb, nb, aw),
                    live_layout(hsrc, hdst.long() - s * nb, nb, hw)))
    return tuple(out)


def make_dist_hits_sweep_cols(mesh: Mesh, mode: str, n_pad: int):
    """Multi-column (N, V) distributed sweep matching ``hits_sweep_cols``.

    ``sweep(h, ca, ch, m, layouts) -> (h_new, a)``: ``ca``/``ch``/``m``
    are replicated (n_rows, V) per-shard lists, ``layouts`` the plan's
    ``edge_layouts_cols``. Each half-step's scatter output is masked to
    the column's base set and h is L1-normalized per column.

    Layouts: ``replicated`` iterates the full (n_pad, V) vector on every
    shard (2 psums/sweep, the 4N rung); ``dual_blocked`` iterates (nb, V)
    blocks over ``nb * S >= n_pad`` rows (2 all-gathers/sweep, the 2N
    rung).
    """
    s_n = mesh.size

    if mode == "replicated":

        def sweep(h, ca, ch, m, layouts):
            a = psum(mesh, [_seg(mesh, h[s] * ch[s], layouts[s][0])
                            for s in range(s_n)])
            a = [x * m[s] for s, x in enumerate(a)]
            h_new = psum(mesh, [_seg(mesh, a[s] * ca[s], layouts[s][1])
                                for s in range(s_n)])
            h_new = [x * m[s] for s, x in enumerate(h_new)]
            h_new = [x / (x.abs().sum(dim=0, keepdim=True) + 1e-30)
                     for x in h_new]
            return h_new, a

        return sweep

    if mode == "dual_blocked":
        nb = -(-n_pad // s_n)

        def sweep(h_blk, ca, ch, m, layouts):
            h_full = all_gather(mesh, h_blk)
            m_blk = [m[s][s * nb:(s + 1) * nb] for s in range(s_n)]
            a_blk = [_seg(mesh, h_full[s] * ch[s], layouts[s][0]) * m_blk[s]
                     for s in range(s_n)]
            a_full = all_gather(mesh, a_blk)
            h_new = [_seg(mesh, a_full[s] * ca[s], layouts[s][1]) * m_blk[s]
                     for s in range(s_n)]
            tot = psum(mesh, [x.abs().sum(dim=0) for x in h_new])
            return [x / (t + 1e-30) for x, t in zip(h_new, tot)], a_blk

        return sweep

    raise ValueError(f"unsupported mode {mode}")


def cast_layouts(layouts, dtype):
    """The layouts with their weights cast to ``dtype`` (the ladder's bulk
    phase); endpoints and lengths are shared."""
    dt = torch_dtype(dtype)
    return tuple(tuple(dataclasses.replace(lay, w=lay.w.to(dt))
                       for lay in per_shard) for per_shard in layouts)


# ring-algorithm wire bytes per collective OUTPUT byte: an all-reduce is
# reduce-scatter + all-gather (~2(S-1)/S), one-phase collectives (S-1)/S
_RING_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                     "reduce-scatter": 1.0, "all-to-all": 1.0,
                     "collective-permute": 1.0}


def wire_bytes_from_collectives(by_kind: dict, n_shards: int) -> float:
    """Convert per-kind collective output bytes (``Mesh.collective_bytes``)
    into ring wire bytes — the metric the ladder above ranks by."""
    if n_shards <= 1:
        return 0.0
    frac = (n_shards - 1) / n_shards
    return sum(b * frac * _RING_WIRE_FACTOR.get(k, 1.0)
               for k, b in by_kind.items())


def collective_bytes_per_sweep_cols(mode: str, n_pad: int, v: int,
                                    n_shards: int, itemsize: int = 8) -> int:
    """Analytic per-device wire bytes per column sweep — the dist ladder.

    Ring-algorithm model (matching ``wire_bytes_from_collectives``):
    replicated = 2 all-reduces at 2·(S-1)/S bytes per payload byte
    (~4·N·V); dual_blocked = 2 all-gathers at (S-1)/S (~2·N·V).
    """
    if n_shards <= 1:
        return 0
    frac = (n_shards - 1) / n_shards
    payload = n_pad * v * itemsize
    if mode == "replicated":
        return int(2 * 2 * payload * frac)
    if mode == "dual_blocked":
        return int(2 * payload * frac)
    raise ValueError(mode)
