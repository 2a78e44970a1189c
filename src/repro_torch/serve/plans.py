"""SweepPlan: the graph-structure-only half of a serving batch, cached
(port of ``repro.serve.plans``).

* ``SweepPlan``     — the backend-specific structural artifact. ``dense``:
                      device edge list with its segment layouts;
                      ``sharded``: pow2-bucketed edge shards on the mesh's
                      devices, their segment layouts, and the shared mesh;
                      ``bsr``: the blocking permutation and both DeviceBSR
                      structures.
* ``structure_key`` — content hash of the padded edge structure; byte-equal
                      to the reference's for the same batch (the dtype is
                      hashed by name, as ``str(np.dtype(...))`` spells it).
* ``PlanCache``     — a small LRU of plans.
* ``lump_batch``/``unlump_cols`` — the plan-time lumped reduction, on the
                      batch's host arrays.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..graph.structure import next_pow2
from ..runtime import dtype_name


def structure_key(src, dst, w, n_pad: int, dtype) -> str:
    """Content hash of the padded union-subgraph structure.

    Everything a plan may depend on is hashed: padded node count, the
    sentinel-padded edge arrays, edge weights, and the sweep dtype. Two
    batches agree on this key iff their structural layout work is
    byte-identical, so a cached plan is always safe to reuse — and a graph
    mutation (same node ids, different edges) necessarily changes the key.
    """
    hsh = hashlib.sha1()
    hsh.update(np.int64(n_pad).tobytes())
    hsh.update(dtype_name(dtype).encode())
    for arr in (src, dst, w):
        a = np.ascontiguousarray(arr)
        hsh.update(str(a.dtype).encode())
        hsh.update(a.tobytes())
    return hsh.hexdigest()


def topology_key(src, dst, n_pad: int, dtype) -> str:
    """Weight-blind twin of ``structure_key``.

    Hashes everything a plan's *layout* depends on — padded node count,
    dtype, and the sentinel-padded endpoint arrays — but not the edge
    values. Two batches share this key iff they differ at most in edge
    weights: the device edge lists and the BSR blocking permutation are
    functions of the endpoints alone (the key a weight-only plan patch
    looks its predecessor up by).
    """
    hsh = hashlib.sha1()
    hsh.update(b"topo:")
    hsh.update(np.int64(n_pad).tobytes())
    hsh.update(dtype_name(dtype).encode())
    for arr in (src, dst):
        a = np.ascontiguousarray(arr)
        hsh.update(str(a.dtype).encode())
        hsh.update(a.tobytes())
    return hsh.hexdigest()


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Base: what every backend's structural artifact carries.

    ``key`` is the ``structure_key`` the plan was built from (sweeps assert
    against the batch), ``backend`` the owning backend's name, ``n_pad``
    the padded node count the layout was sized for. ``ready`` holds one
    CUDA event per card the plan's tensors live on, recorded after they
    were enqueued (empty on the CPU): a plan built on the pipeline's
    prepare thread is complete for the sweep that waits on them, whatever
    streams that sweep runs on.
    """

    key: str
    backend: str
    n_pad: int
    ready: Tuple = ()


@dataclasses.dataclass(frozen=True)
class DensePlan(SweepPlan):
    """Device-resident padded edge list with its segment layouts."""

    edges: object = None  # core.hits.EdgeList, w at the sweep dtype


@dataclasses.dataclass(frozen=True)
class ShardedPlan(SweepPlan):
    """Pow2-bucketed edge shards on the mesh + the (shared) mesh.

    ``eargs`` is the sweep's edge arguments in the reference's
    calling-convention order ((src, dst, w) for replicated; (asrc, adst,
    aw, hsrc, hdst, hw) for dual_blocked), each a tuple of S per-shard
    (per,) tensors on their shard's device. ``layouts`` holds, per shard,
    the (authority, hub) ``SegmentLayout``s of those edges: stably sorted
    by scatter index once, at plan time, for the deterministic segment
    sum. ``mesh`` is the process-wide shared mesh for this device tuple.
    """

    mesh: object = None
    mode: str = ""
    n_shards: int = 0
    per: int = 0         # padded per-shard edge bucket
    nb: int = 0          # dual_blocked node-block size (0 for replicated)
    eargs: Tuple = ()
    layouts: Tuple = ()


@dataclasses.dataclass(frozen=True)
class BsrPlan(SweepPlan):
    """Blocking permutation + both BSR structures for the BSR kernels.

    ``perm``/``inv`` are the ``core.reordering.blocking_permutation`` node
    order and its inverse (host copies, for persistence);
    ``perm_dev``/``inv_dev`` their device-resident int64 twins, gathered at
    the convergence loop's entry/exit so the per-batch vector permutation
    runs on the device.
    ``lt``/``lfwd`` are the transpose/forward DeviceBSR built in the
    permuted space. Per-column diagonals, masks, and start vectors stay
    batch-side (permuted at sweep time, on device).

    ``lt_lo``/``lfwd_lo`` are the precision ladder's low-precision operator
    copies (same idx arrays, blocks cast to the batch's ``bulk_dtype``) —
    present only on plans built for a ladder batch, which is why the
    ladder keys the service plan cache.
    """

    perm: object = None  # np (n_pad,) new -> old
    inv: object = None   # np (n_pad,) old -> new
    perm_dev: object = None  # torch copies of perm/inv for the on-device
    inv_dev: object = None   # entry/exit gathers
    lt: object = None    # DeviceBSR, transpose (authority half-step)
    lfwd: object = None  # DeviceBSR, forward (hub half-step)
    bs: int = 0
    accum_dtype: str = ""  # dtype name of the full-precision accumulator
    lt_lo: object = None    # DeviceBSR at bulk_dtype (None: ladder off)
    lfwd_lo: object = None


class PlanCache:
    """LRU of SweepPlans keyed by (backend, params, structure hash).

    ``capacity <= 0`` disables caching (``get`` always misses and ``put``
    drops). Stats: ``hits`` / ``misses`` / ``evictions``.
    """

    def __init__(self, capacity: int = 64):
        self.capacity = int(capacity)
        self._plans: "OrderedDict[tuple, SweepPlan]" = OrderedDict()
        self.stats: Dict[str, int] = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        return len(self._plans)

    def get(self, key: tuple) -> Optional[SweepPlan]:
        plan = self._plans.get(key)
        if plan is None:
            self.stats["misses"] += 1
            return None
        self._plans.move_to_end(key)
        self.stats["hits"] += 1
        return plan

    def peek(self, key: Optional[tuple]) -> Optional[SweepPlan]:
        """Hit/miss- and LRU-neutral lookup (the delta patch path's probe
        for a predecessor plan)."""
        if key is None:
            return None
        return self._plans.get(key)

    def put(self, key: tuple, plan: SweepPlan):
        if self.capacity <= 0:
            return
        self._plans[key] = plan
        self._plans.move_to_end(key)
        while len(self._plans) > self.capacity:
            self._plans.popitem(last=False)
            self.stats["evictions"] += 1

    def get_or_build(self, key: tuple,
                     build: Callable[[], SweepPlan]) -> SweepPlan:
        plan = self.get(key)
        if plan is None:
            plan = build()
            self.put(key, plan)
        return plan

    def clear(self):
        self._plans.clear()


# ------------------------------------------------------------------ lumping
#
# Plan-time lumped sweep reduction (Dong, Feng & You: the HITS hub-matrix
# iteration can run on a lumped matrix — dangling and duplicate-pattern
# pages collapsed — with an exact unlump at the end). Serving batches are
# padded union subgraphs, so two node populations provably cannot change
# any column's fixed point:
#
# * **isolated rows** — nodes with no induced edge in the union graph
#   (webgraph base sets are dangling-heavy). After the first sweep both
#   their hub and authority mass are identically zero in every column, so
#   they can be dropped outright and scattered back as zeros.
# * **duplicate-pattern rows** — nodes with byte-identical weighted in/out
#   adjacency signatures AND identical per-column ca/ch/mask/h0 rows. Such
#   nodes carry equal scores at every sweep, so each class collapses to
#   one representative whose class multiplicity folds into its ca/ch
#   diagonal entries: the a-half-step sees ch' = m*ch (the class's m
#   identical out-edge fans become one m-weighted fan) and the h-half-step
#   sees ca' = m*ca (the m identical in-edge fans likewise) — exactly the
#   restriction of the full operator, with NO kernel changes.
#
# The reduced batch iterates under a per-column L1 normalization over the
# reduced rows (a scalar per sweep), so its trajectory is the full
# trajectory's restriction up to column scale and converges to the same
# fixed-point direction; ``unlump_cols`` scatters representative scores
# back to every class member and renormalizes in the full space, making
# the published vectors exact. Everything downstream — result cache, warm
# table, spill, ``apply_edge_delta`` invalidation — keeps operating on
# full-space vectors and never sees the reduction.

# "auto" applies the reduction only when it removes at least this fraction
# of the union's live rows — below it the host-side reduction work (and
# the extra plan-cache entry) outweighs the smaller sweep
LUMP_AUTO_MIN_RATIO = 0.125


@dataclasses.dataclass(frozen=True)
class LumpMap:
    """The exact reduction map from the full padded node space to the
    reduced one.

    ``scatter[i]`` is the reduced row whose score full row ``i`` reads at
    unlump: its class representative's slot for surviving nodes, the
    reduced dead pad row (``n_red - 1``, identically zero in every sweep
    output) for dropped isolated rows and padding. ``key`` is a content
    hash of the map — it joins the service plan-cache key (and therefore
    the ``PlanSpill`` record) so lumped and unlumped plans never alias.
    """

    n_full: int
    n_red: int
    scatter: np.ndarray      # (n_full,) int32
    lumped_nodes: int        # live rows removed (dropped + class members)
    ratio: float             # lumped_nodes / live rows
    key: str

    @staticmethod
    def _content_key(scatter: np.ndarray, n_full: int, n_red: int) -> str:
        hsh = hashlib.sha1(b"lump:")
        hsh.update(np.int64(n_full).tobytes())
        hsh.update(np.int64(n_red).tobytes())
        hsh.update(np.ascontiguousarray(scatter).tobytes())
        return hsh.hexdigest()[:16]


def _duplicate_classes(kept, src, dst, w, rows):
    """Group ``kept`` nodes into exact-duplicate classes.

    Signature per node: its sorted weighted out-adjacency, sorted weighted
    in-adjacency, and its row bytes of every per-column array (ca, ch,
    mask, h0 — equal rows are required for scores to stay equal at every
    sweep, including warm starts). Classes whose members appear among
    their own neighbors (intra-class edges, self-loops) are split back to
    singletons: the multiplicity fold is only exact for class-external
    adjacency. Returns {representative: member array}.
    """
    order_out = np.lexsort((dst, src))
    so, do, wo = src[order_out], dst[order_out], w[order_out]
    o0 = np.searchsorted(so, kept, "left")
    o1 = np.searchsorted(so, kept, "right")
    order_in = np.lexsort((src, dst))
    si, di, wi = src[order_in], dst[order_in], w[order_in]
    i0 = np.searchsorted(di, kept, "left")
    i1 = np.searchsorted(di, kept, "right")
    groups: Dict[bytes, list] = {}
    for p, node in enumerate(kept):
        hsh = hashlib.sha1()
        hsh.update(do[o0[p]:o1[p]].tobytes())
        hsh.update(np.ascontiguousarray(wo[o0[p]:o1[p]]).tobytes())
        hsh.update(b"|")
        hsh.update(si[i0[p]:i1[p]].tobytes())
        hsh.update(np.ascontiguousarray(wi[i0[p]:i1[p]]).tobytes())
        for arr in rows:
            hsh.update(b"|")
            hsh.update(np.ascontiguousarray(arr[node]).tobytes())
        groups.setdefault(hsh.digest(), []).append((p, int(node)))
    classes: Dict[int, np.ndarray] = {}
    for members in groups.values():
        nodes = np.asarray([n for _p, n in members], np.int64)
        if len(members) > 1:
            # members share identical neighbor lists, so the first
            # member's slices speak for the whole class
            p = members[0][0]
            nbrs = np.concatenate([do[o0[p]:o1[p]], si[i0[p]:i1[p]]])
            if not np.isin(nbrs, nodes).any():
                classes[int(nodes[0])] = nodes
                continue
        for n in nodes:
            classes[int(n)] = np.asarray([n], np.int64)
    return classes


def lump_batch(batch, min_ratio: float = 0.0):
    """Reduce a ``SweepBatch`` by lumping: drop isolated rows, collapse
    duplicate-pattern classes to multiplicity-weighted representatives.

    Returns ``(reduced_batch, LumpMap)``, or ``(None, None)`` when nothing
    lumps (or the reduction ratio is below ``min_ratio`` — the "auto"
    gate). The reduced batch re-pads to its own pow2 buckets and carries
    the map's content hash in ``lump_key`` (keying the plan cache); every
    non-structural field (tol, max_iter, rank_k, ladder) carries over, so
    backends consume it exactly like a full batch.
    """
    n_pad, _v = batch.h0.shape
    w_full = np.asarray(batch.w)
    real = w_full != 0
    src = np.asarray(batch.src)[real].astype(np.int64, copy=False)
    dst = np.asarray(batch.dst)[real].astype(np.int64, copy=False)
    w = w_full[real]
    mask = np.asarray(batch.mask)
    deg = (np.bincount(src, minlength=n_pad)
           + np.bincount(dst, minlength=n_pad))
    live = (deg > 0) | mask.any(axis=1)
    n_live = int(live.sum())
    # (a) dangling/isolated rows: live but edge-free in the union graph —
    # zero hub AND authority mass in every column from sweep 1 on
    kept = np.flatnonzero(deg > 0)
    # (b) duplicate-pattern classes among the surviving rows
    rows = (np.asarray(batch.ca), np.asarray(batch.ch), mask,
            np.asarray(batch.h0))
    classes = _duplicate_classes(kept, src, dst, w, rows)
    reps = np.asarray(sorted(classes), np.int64)
    lumped = n_live - len(reps)
    ratio = lumped / max(n_live, 1)
    if lumped <= 0 or ratio < float(min_ratio):
        return None, None

    n_red = next_pow2(max(len(reps) + 1, 16))
    slot = np.full(n_pad, n_red - 1, np.int32)
    slot[reps] = np.arange(len(reps), dtype=np.int32)
    scatter = np.full(n_pad, n_red - 1, np.int32)
    mult = np.ones(len(reps))
    for rep, members in classes.items():
        scatter[members] = slot[rep]
        mult[slot[rep]] = len(members)
    lmap = LumpMap(n_full=n_pad, n_red=n_red, scatter=scatter,
                   lumped_nodes=int(lumped), ratio=float(ratio),
                   key=LumpMap._content_key(scatter, n_pad, n_red))

    # reduced edges: representative-to-representative only (member copies
    # of each class's identical fans are what the multiplicity replaces)
    is_rep = np.zeros(n_pad, bool)
    is_rep[reps] = True
    ekeep = is_rep[src] & is_rep[dst]
    rs, rd, rw = slot[src[ekeep]], slot[dst[ekeep]], w[ekeep]
    e_red = len(rs)
    e_pad = next_pow2(max(e_red, 16))
    src_r = np.full(e_pad, n_red - 1, np.int32)
    dst_r = np.full(e_pad, n_red - 1, np.int32)
    w_r = np.zeros(e_pad, w_full.dtype)
    src_r[:e_red], dst_r[:e_red], w_r[:e_red] = rs, rd, rw

    def reduce_rows(arr, scale=None):
        out = np.zeros((n_red,) + arr.shape[1:], arr.dtype)
        out[:len(reps)] = arr[reps]
        if scale is not None:
            out[:len(reps)] *= scale[:, None]
        return out

    red = dataclasses.replace(
        batch, h0=reduce_rows(rows[3]), src=src_r, dst=dst_r, w=w_r,
        ca=reduce_rows(rows[0], mult), ch=reduce_rows(rows[1], mult),
        mask=reduce_rows(mask), lump_key=lmap.key)
    return red, lmap


def unlump_cols(h, a, lmap: LumpMap):
    """Exact unlump of reduced sweep output back to the full node space:
    scatter each representative's score to its class members (dropped and
    pad rows read the reduced dead pad row — identically zero) and
    L1-renormalize per column, recovering the full fixed point."""
    hf = np.asarray(h)[lmap.scatter]
    af = np.asarray(a)[lmap.scatter]
    hf = hf / (np.abs(hf).sum(axis=0, keepdims=True) + 1e-30)
    af = af / (np.abs(af).sum(axis=0, keepdims=True) + 1e-30)
    return hf, af
