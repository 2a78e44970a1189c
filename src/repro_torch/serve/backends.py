"""Pluggable sweep backends for the query-ranking service (port of
``repro.serve.backends``).

``RankService`` assembles one padded union-subgraph batch per traversal —
(n_pad, V) start vectors, per-column induced Ca/Ch weights and base-set
masks, and a sentinel-padded edge list — and hands it to a backend that
runs the masked multi-column accelerated-HITS convergence loop:

* ``dense`` — ``core.hits.hits_sweep_cols`` on the deterministic segmented
              SpMV (``sparse.spmv``), a per-sweep torch loop.
* ``sharded`` — the same column sweep over a mesh of devices
              (``sparse.dist.make_dist_hits_sweep_cols``, one process over
              a tuple of devices); edge shards follow the dist ladder
              (``replicated``: 2 psums/sweep, ``dual_blocked``: 2
              all-gathers/sweep).
* ``bsr``   — the hand-written BSR kernels (``kernels.bsr_spmm``) after
              the blocking permutation; the loop runs on the device by
              default (``kernels.bsr_converge_cols``, one CUDA graph per
              batch), ``fused=False``
              keeps the host-driven loop as its parity reference.

Each backend splits its work along the plan/sweep seam (``serve.plans``):
``plan(batch)`` builds the structure-only artifact on the backend's
device and ``sweep(plan, batch)`` runs the loop against it, returning
numpy (h, a, conv, res). Backends run on ``device`` ("cuda" unless the
caller asks for "cpu"); on CPU tensors every kernel wrapper runs its plain
torch version.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.hits import EdgeList, hits_sweep_cols
from ..core.reordering import blocking_permutation
from ..graph.structure import Graph
from ..kernels.ops import DeviceBSR, bsr_converge, bsr_matvec, bsr_revalue
from ..runtime import (dtype_name, from_host, host_array, resolve_device,
                       tol_in, torch_dtype)
from ..sparse import dist
from ..sparse.spmv import normalize_l1
from .plans import (BsrPlan, DensePlan, ShardedPlan, SweepPlan,
                    structure_key)

BACKENDS = ("dense", "sharded", "bsr")

# auto heuristic: sharding pays once the union subgraph's per-sweep edge
# work dwarfs the collective latency; BSR pays in the dense-block regime
# when its kernels run on the card
_SHARD_MIN_EDGES = 4096
_BSR_MIN_EDGES_PER_NODE = 8.0

# --------------------------------------------------------- precision ladder

# accepted spellings for RankServiceConfig.sweep_dtype
_SWEEP_DTYPES = {
    "bf16": "bfloat16", "bfloat16": "bfloat16",
    "fp32": "float32", "f32": "float32", "float32": "float32",
    "fp64": "float64", "f64": "float64", "float64": "float64",
}


def resolve_sweep_dtype(name) -> Optional[str]:
    """Canonical dtype name for a ``sweep_dtype`` spelling; ''/None
    disables the ladder (returns None). Raises ValueError on junk."""
    if name is None or name == "":
        return None
    if not isinstance(name, str):
        return dtype_name(name)  # already dtype-like
    canon = _SWEEP_DTYPES.get(name.lower())
    if canon is None:
        raise ValueError(f"unknown sweep_dtype {name!r} "
                         f"(want one of {sorted(set(_SWEEP_DTYPES))})")
    return canon


def dtype_floor(dtype) -> float:
    """The smallest L1 residual iteration at ``dtype`` can reliably
    resolve: 1e3 * eps (the clamp ``RankService`` applies to ``tol``)."""
    return 1e3 * float(torch.finfo(torch_dtype(dtype)).eps)


def bulk_stop_tol(bulk_dtype, tol: float) -> float:
    """The ladder's switch-over tolerance: the bulk phase stops once its
    residual reaches max(tol, the bulk dtype's floor)."""
    return max(float(tol), dtype_floor(bulk_dtype))


@dataclasses.dataclass(frozen=True)
class SweepBatch:
    """One padded serving batch (host arrays; see ServePipeline.assemble).

    h0/ca/ch/mask: (n_pad, V); src/dst/w: (e_pad,) with sentinel edges
    pointing at the dead pad row n_pad-1 carrying w=0. ``dtype`` and
    ``bulk_dtype`` are dtype names ("float64", "float32", "bfloat16"; None:
    ladder off). ``rank_k``/``stable_sweeps``: the rank-stability stop;
    ``lump_key``: the lump map's hash for a lump-reduced batch ('' = full).
    """

    h0: np.ndarray
    src: np.ndarray
    dst: np.ndarray
    w: np.ndarray
    ca: np.ndarray
    ch: np.ndarray
    mask: np.ndarray
    tol: float
    max_iter: int
    dtype: str
    rank_k: int = 0
    stable_sweeps: int = 2
    bulk_dtype: Optional[str] = None
    lump_key: str = ""

    def structure_key(self) -> str:
        """Hash of the structure-only fields a plan may depend on."""
        return structure_key(self.src, self.dst, self.w, self.h0.shape[0],
                             self.dtype)

    def ladder_key(self) -> str:
        """The batch's precision-ladder marker ('' = single-phase); part of
        the service plan-cache key."""
        return "" if self.bulk_dtype is None else dtype_name(self.bulk_dtype)

    def bulk_tol(self) -> float:
        """The bulk phase's stop tolerance (0.0 when the ladder is off)."""
        return (0.0 if self.bulk_dtype is None
                else bulk_stop_tol(self.bulk_dtype, self.tol))


def _record_ready(*devices) -> tuple:
    """One event per CUDA device after everything enqueued so far on it
    (none on the CPU)."""
    out = []
    for dev in dict.fromkeys(devices):
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            out.append(ev)
    return tuple(out)


def _topk_rows(a, k: int):
    """(V, k) indices of each column's k largest entries, lowest index
    first among equal values (``lax.top_k``)."""
    return torch.sort(a.T.double(), dim=1, descending=True,
                      stable=True).indices[:, :k].int()


class SweepBackend:
    """Interface: plan the structure, then converge batches against it.

    ``sweep(plan, batch)`` returns (h, a, conv, res) numpy arrays —
    ``h``/``a`` (n_pad, V) per-column L1-normalized hub/authority vectors,
    ``conv[j]`` the sweep at which column j stopped (max_iter when it never
    did), ``res[j]`` the certificate ‖sweep(h) − h‖₁ from one extra
    full-precision sweep. ``plan_params()`` feeds the plan-cache key.
    """

    name: str = "?"

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def plan_params(self) -> tuple:
        return ()

    def plan(self, batch: SweepBatch, key: str = "") -> SweepPlan:
        raise NotImplementedError

    def sweep(self, plan: SweepPlan, batch: SweepBatch
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        raise NotImplementedError

    def converge(self, batch: SweepBatch
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        return self.sweep(self.plan(batch), batch)

    def plan_arrays(self, plan: SweepPlan) -> Tuple[Dict, dict]:
        """The plan's persistable form: ({name: host array}, json-meta),
        the same arrays and meta the reference backend writes."""
        raise NotImplementedError

    def plan_restore(self, key: str, arrays: Dict, meta: dict) -> SweepPlan:
        """Inverse of ``plan_arrays``; also takes the reference backend's."""
        raise NotImplementedError

    def patch(self, plan: SweepPlan, batch: SweepBatch,
              key: str = "") -> Optional[SweepPlan]:
        """Value-only update: a plan for ``batch`` built from ``plan``.

        ``plan`` and ``batch`` share a ``plans.topology_key`` — same padded
        endpoints, different edge weights (an edge-weight delta). Backends
        that can reuse the old plan's layout return the patched plan, keyed
        by ``key`` (the batch's new structure_key); None means the caller
        replans.
        """
        return None

    def _check(self, plan: SweepPlan, batch: SweepBatch):
        if plan.backend != self.name or plan.n_pad != batch.h0.shape[0]:
            raise ValueError(
                f"plan {plan.backend!r}/n_pad={plan.n_pad} does not fit "
                f"batch {self.name!r}/n_pad={batch.h0.shape[0]}")
        # built on another thread's stream: every device the sweep runs on
        # waits for every device's copies
        for dev in self._devices():
            for ev in plan.ready:
                torch.cuda.current_stream(dev).wait_event(ev)

    def _devices(self) -> tuple:
        """The distinct devices this backend's plans and sweeps live on."""
        return (self.device,)

    def _tensors(self, b: SweepBatch):
        """The batch's (h0, ca, ch, mask) on the device at the sweep dtype."""
        dt = torch_dtype(b.dtype)
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, dt) for x in (b.h0, b.ca, b.ch, b.mask))


def _numpy(*ts):
    """Host copies of a sweep's outputs; a bf16 service's vectors come
    back as float32, which holds every bf16 value exactly (numpy has no
    bf16)."""
    return tuple((t.float() if t.dtype == torch.bfloat16 else t).cpu()
                 .numpy() for t in ts)


# ------------------------------------------------------------------- dense


def _col_l1(h_new, h):
    return (h_new - h).abs().sum(dim=0)


def _converge(sweep, h0, tol: float, max_iter: int, v: int, device,
              k_eff: int = 0, stable_sweeps: int = 2, sweep_lo=None,
              bulk_dtype=None, bulk_tol: float = 0.0, delta=_col_l1,
              rows=lambda x: x, cast=lambda h, dt: h.to(dt)):
    """The host-driven convergence loop for V masked columns (the
    reference's ``_converge_batch`` and ``_sharded_converge``): per-column
    L1 residual ``delta(h_new, h)`` and optional rank stability over
    ``rows(a)`` (the authority's (rows, V) tensor on ``device``), the
    ladder's bulk phase (``sweep_lo`` at ``bulk_dtype``) first when set
    (``max_iter`` bounds the total, rank state resets at the switch), and
    one extra full-precision sweep for the certificate. ``h0`` is whatever
    ``sweep`` iterates (a tensor, or a sharded vector that ``cast`` casts).
    Returns (rows(h), normalized rows(a), conv, res)."""
    i32 = dict(dtype=torch.int32, device=device)

    def loop(sweep_fn, h, k, stop_tol):
        conv = torch.full((v,), -1, **i32)
        top_prev = torch.full((v, k_eff), -1, **i32)
        stab = torch.zeros(v, **i32)
        while k < max_iter and bool((conv < 0).any()):
            h_new, a = sweep_fn(h)
            dl = delta(h_new, h)
            stop = dl.double() <= tol_in(stop_tol, dl.dtype)
            if k_eff:
                top = _topk_rows(rows(a), k_eff)
                stab = torch.where((top == top_prev).all(dim=1), stab + 1, 0)
                stop = stop | (stab >= stable_sweeps)
                top_prev = top
            conv = torch.where((conv < 0) & stop, k + 1, conv)
            h, k = h_new, k + 1
        return h, k, conv

    k = 0
    if bulk_dtype is not None:
        dt = (h0[0] if isinstance(h0, list) else h0).dtype
        h_lo, k, _ = loop(sweep_lo, cast(h0, torch_dtype(bulk_dtype)), k,
                          bulk_tol)
        h0 = cast(h_lo, dt)
    h, k, conv = loop(sweep, h0, k, tol)
    conv = torch.where(conv < 0, k, conv)
    h2, a = sweep(h)
    res = delta(h2, h)
    return rows(h), normalize_l1(rows(a), axis=0), conv, res


def _converge_dense(edges: EdgeList, h0, ca, ch, mask, tol: float,
                    max_iter: int, rank_k: int = 0, stable_sweeps: int = 2,
                    bulk_dtype=None, bulk_tol: float = 0.0):
    """``_converge`` over the single-device column sweep
    (``core.hits.hits_sweep_cols``)."""
    sweep_lo = None
    if bulk_dtype is not None:
        bd = torch_dtype(bulk_dtype)
        sweep_lo = hits_sweep_cols(edges.astype(bd), ca.to(bd), ch.to(bd),
                                   mask.to(bd))
    return _converge(
        hits_sweep_cols(edges, ca, ch, mask), h0, tol, max_iter, h0.shape[1],
        h0.device, k_eff=min(int(rank_k), h0.shape[0]) if rank_k else 0,
        stable_sweeps=stable_sweeps, sweep_lo=sweep_lo,
        bulk_dtype=bulk_dtype, bulk_tol=bulk_tol)


class DenseSweepBackend(SweepBackend):
    """Single-device gather/segmented-sum path (the semantic reference)."""

    name = "dense"

    def _edges(self, src, dst, w, n_pad: int, dtype=None) -> EdgeList:
        """The device edge list of host arrays; ``dtype`` None keeps the
        weights' own (2-byte voids are bf16 patterns)."""
        t = lambda x, dt: from_host(x).to(self.device, dt)  # noqa: E731
        w = from_host(w)
        return EdgeList.build(t(src, torch.int64), t(dst, torch.int64), n_pad,
                              w.to(self.device, w.dtype if dtype is None
                                   else torch_dtype(dtype)))

    def plan(self, b: SweepBatch, key: str = "") -> DensePlan:
        n_pad = b.h0.shape[0]
        return DensePlan(key=key or b.structure_key(), backend=self.name,
                         n_pad=n_pad,
                         edges=self._edges(b.src, b.dst, b.w, n_pad, b.dtype),
                         ready=_record_ready(self.device))

    def plan_arrays(self, plan: DensePlan):
        e = plan.edges
        # bf16 weights persist as the reference writes them: raw 2-byte
        # patterns (runtime.host_array)
        return ({"src": e.src.int().cpu().numpy(),
                 "dst": e.dst.int().cpu().numpy(),
                 "w": host_array(e.w)}, {"n_pad": int(plan.n_pad)})

    def plan_restore(self, key: str, arrays, meta) -> DensePlan:
        n_pad = int(meta["n_pad"])
        return DensePlan(key=key, backend=self.name, n_pad=n_pad,
                         edges=self._edges(arrays["src"], arrays["dst"],
                                           arrays["w"], n_pad),
                         ready=_record_ready(self.device))

    def patch(self, plan: DensePlan, b: SweepBatch,
              key: str = "") -> DensePlan:
        """Only the weights ship. The layouts hold the edges sorted by
        target, so they are rebuilt on the device from the old plan's
        endpoints with the new weights, pairing each weight with its edge
        in both sort orders."""
        self._check(plan, b)
        e = plan.edges
        w = torch.from_numpy(np.ascontiguousarray(b.w)).to(
            self.device, torch_dtype(b.dtype))
        return DensePlan(key=key or b.structure_key(), backend=self.name,
                         n_pad=plan.n_pad,
                         edges=EdgeList.build(e.src, e.dst, e.n, w),
                         ready=_record_ready(self.device))

    def sweep(self, plan: DensePlan, b: SweepBatch):
        self._check(plan, b)
        h0, ca, ch, m = self._tensors(b)
        out = _converge_dense(plan.edges, h0, ca, ch, m, b.tol, b.max_iter,
                              rank_k=int(b.rank_k),
                              stable_sweeps=int(b.stable_sweeps),
                              bulk_dtype=b.bulk_dtype, bulk_tol=b.bulk_tol())
        return _numpy(*out)


# ----------------------------------------------------------------- sharded

# process-wide mesh per (device tuple, axes): meshes are pure structure, so
# every backend instance (and every plan) over the same device tuple
# shares ONE object
_MESH_CACHE: Dict[tuple, dist.Mesh] = {}


def shared_mesh(devices, axes) -> dist.Mesh:
    devices = tuple(torch.device(d) for d in devices)
    key = (tuple(str(d) for d in devices), tuple(axes))
    mesh = _MESH_CACHE.get(key)
    if mesh is None:
        mesh = _MESH_CACHE[key] = dist.Mesh(devices, (len(devices),), axes)
    return mesh


def _sharded_converge(plan: ShardedPlan, h0, ca, ch, m, v: int, tol: float,
                      max_iter: int, rank_k: int = 0, stable_sweeps: int = 2,
                      bulk_dtype=None, bulk_tol: float = 0.0):
    """``_converge`` over the mesh (the reference's ``_sharded_converge``).

    The per-column L1 stop sums each shard's rows and adds the shards in
    order (a psum); the rank-stability stop ranks ``a``'s node-major rows,
    where blocked layouts' dead rows are zero and rank below every real
    score (lowest index first); the bulk phase casts the edge weights and
    the column arrays to the bulk dtype."""
    mesh = plan.mesh
    sweep_of = dist.make_dist_hits_sweep_cols(mesh, plan.mode, plan.n_pad)
    blocked = plan.mode == "dual_blocked"

    def bind(layouts, dt=None):
        cas = (ca, ch, m) if dt is None else tuple(
            _each(x, lambda t: t.to(dt)) for x in (ca, ch, m))
        return lambda h: sweep_of(h, *cas, layouts)

    def delta(h_new, h):
        if not blocked:
            return _col_l1(h_new[0], h[0])
        return dist.psum(mesh, [_col_l1(x, y) for x, y in zip(h_new, h)])[0]

    def rows(x):
        return dist.all_gather(mesh, x)[0] if blocked else x[0]

    sweep_lo = None
    if bulk_dtype is not None:
        bd = torch_dtype(bulk_dtype)
        sweep_lo = bind(dist.cast_layouts(plan.layouts, bd), bd)
    return _converge(
        bind(plan.layouts), h0, tol, max_iter, v, mesh.devices[0],
        k_eff=min(int(rank_k), plan.n_pad) if rank_k else 0,
        stable_sweeps=stable_sweeps, sweep_lo=sweep_lo,
        bulk_dtype=bulk_dtype, bulk_tol=bulk_tol, delta=delta, rows=rows,
        cast=lambda h, dt: _each(h, lambda x: x.to(dt)))


def _each(parts, fn):
    """``fn`` of every part, computed once per distinct tensor (shards on
    one device share their replicated values)."""
    memo = {}
    for x in parts:
        if id(x) not in memo:
            memo[id(x)] = fn(x)
    return [memo[id(x)] for x in parts]


class ShardedSweepBackend(SweepBackend):
    """Mesh-sharded column sweep over the dist.py edge-sharding ladder.

    One process drives ``n_devices`` shards (None: every visible device of
    ``device``'s type — 1 on the CPU, ``torch.cuda.device_count()`` on
    "cuda"), placed round-robin over those devices (``dist.make_mesh``):
    more shards than devices run as logical shards that share one.
    """

    name = "sharded"

    def __init__(self, mode: str = "dual_blocked",
                 n_devices: Optional[int] = None, device="cuda"):
        super().__init__(device)
        if mode not in ("replicated", "dual_blocked"):
            raise ValueError(f"unknown shard mode {mode!r}")
        s = (len(dist.visible_devices(self.device)) if n_devices is None
             else int(n_devices))
        if s < 1:
            raise ValueError(f"n_devices={s} must be >= 1")
        self.mode = mode
        self.n_shards = s
        self.axes = ("data",)  # the reference's axis name: in plan keys
        self.mesh = shared_mesh(dist.round_robin(s, self.device), self.axes)

    def _devices(self) -> tuple:
        return self.mesh.distinct_devices()

    def collective_bytes_per_sweep(self, n_pad: int, v: int,
                                   itemsize: int = 8) -> int:
        """Analytic per-device wire bytes per sweep (the dist ladder)."""
        return dist.collective_bytes_per_sweep_cols(self.mode, n_pad, v,
                                                    self.n_shards, itemsize)

    def plan_params(self) -> tuple:
        return (self.mode, self.n_shards, self.axes)

    def _plan(self, key: str, n_pad: int, per: int, nb: int,
              eargs) -> ShardedPlan:
        layouts = dist.edge_layouts_cols(self.mesh, self.mode, eargs, n_pad)
        return ShardedPlan(key=key, backend=self.name, n_pad=n_pad,
                           mesh=self.mesh, mode=self.mode,
                           n_shards=self.n_shards, per=per, nb=nb,
                           eargs=eargs, layouts=layouts,
                           ready=_record_ready(*self._devices()))

    def plan(self, b: SweepBatch, key: str = "") -> ShardedPlan:
        """Host-side edge partition + the copies to the shards' devices +
        each shard's segment layouts."""
        n_pad = b.h0.shape[0]
        shards = dist.build_edge_shards_cols(b.src, b.dst, b.w, n_pad,
                                             self.n_shards, self.mode)
        return self._plan(key or b.structure_key(), n_pad, shards["per"],
                          int(shards.get("nb", 0)),
                          dist.device_put_edge_args_cols(shards, b.dtype,
                                                         self.mesh))

    def plan_arrays(self, plan: ShardedPlan):
        # the eargs ARE the layout: (S, per) arrays in calling-convention
        # order, as the reference writes them; the mesh is process state
        arrays = {f"earg{i}": np.stack([host_array(x) for x in arg])
                  for i, arg in enumerate(plan.eargs)}
        return arrays, {"n_pad": int(plan.n_pad), "mode": plan.mode,
                        "n_shards": int(plan.n_shards),
                        "per": int(plan.per), "nb": int(plan.nb),
                        "n_eargs": len(plan.eargs)}

    def plan_restore(self, key: str, arrays, meta) -> ShardedPlan:
        """Rehydrate ``plan_arrays`` output — this backend's or the JAX
        package's (the same arrays and meta)."""
        if meta["mode"] != self.mode or int(meta["n_shards"]) != self.n_shards:
            raise ValueError("spilled plan laid out for a different "
                             f"shard config: {meta}")
        eargs = tuple(
            tuple(self.mesh.shard_rows(from_host(arrays[f"earg{i}"])))
            for i in range(int(meta["n_eargs"])))
        return self._plan(key, int(meta["n_pad"]), int(meta["per"]),
                          int(meta["nb"]), eargs)

    def patch(self, plan: ShardedPlan, b: SweepBatch,
              key: str = "") -> Optional[ShardedPlan]:
        """Weight-only update keeping the device endpoint planes.

        The pow2 bucketing is a function of the kept edge endpoints alone
        and a weight-only delta keeps the w != 0 mask, so the successor
        batch repacks into identical endpoint planes: only the weight
        planes ship, and the layouts are re-sorted on the devices from the
        old endpoints. Returns None when the repacked buckets would not fit
        the old layout (per/nb drift)."""
        self._check(plan, b)
        shards = dist.build_edge_shards_cols(b.src, b.dst, b.w, plan.n_pad,
                                             self.n_shards, self.mode)
        if shards["mode"] != plan.mode or int(shards["per"]) != plan.per \
                or int(shards.get("nb", 0)) != plan.nb:
            return None
        dt = torch_dtype(b.dtype)
        new = [tuple(self.mesh.shard_rows(from_host(part["w"]).to(dt)))
               for part in ((shards,) if plan.mode == "replicated"
                            else (shards["a"], shards["h"]))]
        e = plan.eargs
        if plan.mode == "replicated":
            eargs = (e[0], e[1], new[0])
        else:
            eargs = (e[0], e[1], new[0], e[3], e[4], new[1])
        return self._plan(key or b.structure_key(), plan.n_pad, plan.per,
                          plan.nb, eargs)

    def _vector_layout(self, plan: ShardedPlan, h0, ca, ch, m, dtype):
        """Per-batch device layout of the (n_pad, V) vectors: ca/ch/m
        replicated on every shard's device; h0 replicated (``replicated``)
        or in (nb, V) blocks (``dual_blocked``, rows padded to nb*S >=
        n_pad: non-power-of-two shard counts get dead extra rows with zero
        weights, mask and h0, like the service's pad row)."""
        dt = torch_dtype(dtype)
        as_t = lambda x: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(x)).to(dt)
        if plan.mode == "dual_blocked":
            n_rows, v = np.shape(h0)
            rows = ((0, plan.nb * plan.n_shards - n_rows), (0, 0))
            h0, ca, ch, m = (np.pad(np.asarray(x), rows)
                             for x in (h0, ca, ch, m))
            h = self.mesh.shard_rows(
                as_t(h0).reshape(plan.n_shards, plan.nb, v))
        else:
            h = self.mesh.replicate(as_t(h0))
        return (h,) + tuple(self.mesh.replicate(as_t(x)) for x in (ca, ch, m))

    def sweep(self, plan: ShardedPlan, b: SweepBatch):
        self._check(plan, b)
        n_pad, v = b.h0.shape
        h0, ca, ch, m = self._vector_layout(plan, b.h0, b.ca, b.ch, b.mask,
                                            b.dtype)
        h, a, conv, res = _sharded_converge(
            plan, h0, ca, ch, m, v, b.tol, b.max_iter, rank_k=int(b.rank_k),
            stable_sweeps=int(b.stable_sweeps), bulk_dtype=b.bulk_dtype,
            bulk_tol=b.bulk_tol())
        return _numpy(h[:n_pad], a[:n_pad], conv, res)

    def measure_wire_bytes(self, n_pad: int, v: int, src, dst, w,
                           dtype="float64") -> float:
        """Per-device ring wire bytes of ONE sweep at these shapes, from
        the mesh's collective counters (the reference reads the same sizes
        from the compiled HLO)."""
        zeros = np.zeros((n_pad, v))
        plan = self.plan(SweepBatch(
            h0=zeros, src=src, dst=dst, w=w, ca=zeros, ch=zeros, mask=zeros,
            tol=0.0, max_iter=1, dtype=dtype))
        h0, ca, ch, m = self._vector_layout(plan, zeros, zeros, zeros,
                                            zeros, dtype)
        sweep = dist.make_dist_hits_sweep_cols(self.mesh, self.mode, n_pad)
        before = dict(self.mesh.collective_bytes)
        sweep(h0, ca, ch, m, plan.layouts)
        by_kind = {k: b - before.get(k, 0)
                   for k, b in self.mesh.collective_bytes.items()}
        return dist.wire_bytes_from_collectives(by_kind, self.n_shards)


# --------------------------------------------------------------------- bsr


class BsrSweepBackend(SweepBackend):
    """Block-sparse kernel path for the dense-block regime.

    The union subgraph is renumbered by ``core.reordering``'s blocking
    permutation (non-dangling pages first, degree-descending) so structural
    nonzeros cluster into dense (bs x bs) blocks, then each half-step is one
    K1 launch with the column's induced diagonal fused in. The loop runs on
    the device by default (``kernels.bsr_converge_cols``: one CUDA graph
    built, launched and read once per batch); ``fused=False`` keeps the
    host-driven loop, one host round trip per sweep, as its parity
    reference.
    """

    name = "bsr"

    def __init__(self, bs: int = 128, fused: bool = True, device="cuda"):
        super().__init__(device)
        self.bs = bs
        self.fused = fused

    def plan_params(self) -> tuple:
        return (self.bs,)

    def _plan(self, key: str, n_pad: int, perm, inv, lt: DeviceBSR,
              lfwd: DeviceBSR, accum: str, bulk, perm_dev=None,
              inv_dev=None) -> BsrPlan:
        lt_lo = lfwd_lo = None
        if bulk:
            # ladder: low-precision operator copies share the idx arrays;
            # only the block values are cast (the bulk phase's working set)
            lt_lo, lfwd_lo = lt.astype(bulk), lfwd.astype(bulk)
        as_dev = lambda p: torch.from_numpy(p.astype(np.int64)).to(  # noqa: E731
            self.device)
        return BsrPlan(key=key, backend=self.name, n_pad=n_pad,
                       perm=perm, inv=inv,
                       perm_dev=as_dev(perm) if perm_dev is None else perm_dev,
                       inv_dev=as_dev(inv) if inv_dev is None else inv_dev,
                       lt=lt, lfwd=lfwd, bs=lt.bs,
                       accum_dtype=accum, lt_lo=lt_lo, lfwd_lo=lfwd_lo,
                       ready=_record_ready(self.device))

    def plan(self, b: SweepBatch, key: str = "") -> BsrPlan:
        """Blocking permutation + both BSR structures — the expensive
        host-side layout work (two block builds) repeat batches skip."""
        n_pad = b.h0.shape[0]
        real = np.asarray(b.w) != 0  # drop sentinel padding edges
        src, dst = np.asarray(b.src)[real], np.asarray(b.dst)[real]
        w = np.asarray(b.w)[real]
        perm = blocking_permutation(src, dst, n_pad)
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n_pad, dtype=np.int32)
        g = Graph(n_pad, inv[src], inv[dst])
        bs = min(self.bs, n_pad)
        accum = "float64" if dtype_name(b.dtype) == "float64" else "float32"
        lt = DeviceBSR.build(g, bs, transpose=True, dtype=b.dtype, values=w,
                             device=self.device)
        lfwd = DeviceBSR.build(g, bs, transpose=False, dtype=b.dtype,
                               values=w, device=self.device)
        return self._plan(key or b.structure_key(), n_pad, perm, inv, lt,
                          lfwd, accum, b.bulk_dtype)

    def plan_arrays(self, plan: BsrPlan):
        arrays = {"perm": np.asarray(plan.perm), "inv": np.asarray(plan.inv),
                  "lt_blocks": host_array(plan.lt.blocks),
                  "lt_idx": plan.lt.idx.cpu().numpy(),
                  "lfwd_blocks": host_array(plan.lfwd.blocks),
                  "lfwd_idx": plan.lfwd.idx.cpu().numpy()}
        # the lo operator copies are NOT persisted — they're a cast of the
        # full-precision blocks, rebuilt from them at restore
        bulk = "" if plan.lt_lo is None else dtype_name(plan.lt_lo.blocks.dtype)
        return arrays, {"n_pad": int(plan.n_pad), "bs": int(plan.bs),
                        "bsr_n_nodes": int(plan.lt.n_nodes),
                        "bsr_n_pad": int(plan.lt.n_pad),
                        "accum": plan.accum_dtype, "bulk": bulk}

    def plan_restore(self, key: str, arrays, meta) -> BsrPlan:
        """Rehydrate ``plan_arrays`` output — this backend's or the JAX
        package's (the same numpy arrays and meta)."""
        bs = int(meta["bs"])
        if bs != min(self.bs, int(meta["n_pad"])):
            raise ValueError(f"spilled plan blocked at bs={bs}, "
                             f"backend wants {self.bs}")
        nn, npd = int(meta["bsr_n_nodes"]), int(meta["bsr_n_pad"])
        lt = DeviceBSR.from_arrays(arrays["lt_blocks"], arrays["lt_idx"], bs,
                                   nn, npd, self.device)
        lfwd = DeviceBSR.from_arrays(arrays["lfwd_blocks"],
                                     arrays["lfwd_idx"], bs, nn, npd,
                                     self.device)
        accum = "float64" if meta["accum"] == "float64" else "float32"
        perm = np.asarray(arrays["perm"], np.int32)
        inv = np.asarray(arrays["inv"], np.int32)
        return self._plan(key, int(meta["n_pad"]), perm, inv, lt, lfwd,
                          accum, meta.get("bulk") or None)

    def patch(self, plan: BsrPlan, b: SweepBatch,
              key: str = "") -> Optional[BsrPlan]:
        """Weight-only update keeping the blocking permutation and block
        layout: re-scatter the new edge values into the existing idx
        tables (``kernels.ops.bsr_revalue``) and ship only the block
        arrays (and the ladder's casts of them); perm, idx and row_ptr
        stay on the device. Returns None when a retained edge falls
        outside the old block layout — the caller replans."""
        self._check(plan, b)
        real = np.asarray(b.w) != 0  # drop sentinel padding edges
        src, dst = np.asarray(b.src)[real], np.asarray(b.dst)[real]
        w = np.asarray(b.w)[real]
        inv = np.asarray(plan.inv)
        ps, pd = inv[src], inv[dst]
        ops = []
        # lt was built transposed (Graph.reverse swaps endpoints)
        for op, (s, d) in ((plan.lt, (pd, ps)), (plan.lfwd, (ps, pd))):
            blocks = bsr_revalue(op.idx.cpu().numpy(), plan.bs, op.n_pad, s,
                                 d, w)
            if blocks is None:
                return None
            ops.append(dataclasses.replace(op, blocks=torch.from_numpy(
                blocks).to(torch_dtype(b.dtype)).to(self.device)))
        # _plan records a fresh ready event after these copies
        return self._plan(key or b.structure_key(), plan.n_pad, plan.perm,
                          plan.inv, ops[0], ops[1], plan.accum_dtype,
                          b.bulk_dtype, plan.perm_dev, plan.inv_dev)

    def sweep(self, plan: BsrPlan, b: SweepBatch):
        self._check(plan, b)
        # batch vectors upload unpermuted; the blocking permutation is an
        # on-device gather (entry) / inverse gather (exit)
        h, ca, ch, m = self._tensors(b)
        if self.fused:
            out = bsr_converge(
                plan.lt, plan.lfwd, h, ca, ch, m, b.tol, b.max_iter,
                plan.accum_dtype, perm=plan.perm_dev, inv=plan.inv_dev,
                rank_k=int(b.rank_k), stable_sweeps=int(b.stable_sweeps),
                lt_lo=plan.lt_lo, lfwd_lo=plan.lfwd_lo,
                bulk_tol=b.bulk_tol(), bulk_dtype=b.bulk_dtype)
            return _numpy(*out)
        return self._host_loop(plan, b, h, ca, ch, m)

    def _host_loop(self, plan: BsrPlan, b: SweepBatch, h, ca, ch, m):
        """The host-driven reference loop: one residual round trip per
        sweep (entry/exit permutation still on the device)."""
        perm_d, inv_d = plan.perm_dev, plan.inv_dev
        h, ca, ch, m = (x.index_select(0, perm_d) for x in (h, ca, ch, m))
        v = b.h0.shape[1]
        k_eff = min(int(b.rank_k), b.h0.shape[0]) if b.rank_k else 0

        def host_loop(lt_op, lfwd_op, hh, cah, chh, mh, stop_tol, k, accum):
            # rank-stability state is loop-local: it resets at the ladder's
            # phase boundary, mirroring the device loop exactly
            if k_eff:
                top_prev = np.full((v, k_eff), -1, np.int64)
                stab = np.zeros(v, np.int64)
            conv = np.full(v, -1, np.int32)
            while k < b.max_iter and (conv < 0).any():
                a = bsr_matvec(lt_op, hh, chh, accum) * mh
                h_new = normalize_l1(bsr_matvec(lfwd_op, a, cah, accum) * mh,
                                     axis=0)
                delta = (h_new - hh).abs().sum(dim=0)
                stop = (delta.double() <= tol_in(stop_tol, delta.dtype)
                        ).cpu().numpy()
                if k_eff:
                    # stable argsort of -a == lax.top_k's lowest-index ties
                    top = np.argsort(-a.double().cpu().numpy(), axis=0,
                                     kind="stable")[:k_eff].T
                    stab = np.where((top == top_prev).all(axis=1), stab + 1, 0)
                    stop = stop | (stab >= int(b.stable_sweeps))
                    top_prev = top
                k += 1
                conv = np.where((conv < 0) & stop, k, conv)
                hh = h_new
            return hh, k, conv

        k = 0
        if plan.lt_lo is not None:
            bd = plan.lt_lo.blocks.dtype
            h_lo, k, _ = host_loop(plan.lt_lo, plan.lfwd_lo, h.to(bd),
                                   ca.to(bd), ch.to(bd), m.to(bd),
                                   b.bulk_tol(), k, torch.float32)
            h = h_lo.to(torch_dtype(b.dtype))
        h, k, conv = host_loop(plan.lt, plan.lfwd, h, ca, ch, m, b.tol, k,
                               plan.accum_dtype)
        conv = np.where(conv < 0, k, conv)
        # finalize + certificate: one extra full-precision sweep
        a = bsr_matvec(plan.lt, h, ch, plan.accum_dtype) * m
        h2 = normalize_l1(bsr_matvec(plan.lfwd, a, ca, plan.accum_dtype) * m,
                          axis=0)
        res = (h2 - h).abs().sum(dim=0).cpu().numpy()
        a = normalize_l1(a, axis=0)
        h, a = _numpy(h.index_select(0, inv_d), a.index_select(0, inv_d))
        return h, a, conv, res


# ------------------------------------------------------- selection/factory


def select_backend(n_union: int, e_union: int,
                   n_devices: Optional[int] = None,
                   cuda: Optional[bool] = None) -> str:
    """The ``auto`` heuristic: pick a backend from subgraph density and
    device count (None: the visible cards, or 1 without one).

    Multi-device hosts shard once the union subgraph carries enough edges
    to amortize per-sweep collectives; single-device dense-block subgraphs
    take the BSR kernels when the device is CUDA (their plain versions on
    the CPU would serve slower than the dense path); everything else stays
    dense.
    """
    if cuda is None:
        cuda = torch.cuda.is_available()
    if n_devices is None:
        n_devices = torch.cuda.device_count() if cuda else 1
    if n_devices > 1 and e_union >= _SHARD_MIN_EDGES:
        return "sharded"
    if cuda and e_union >= _BSR_MIN_EDGES_PER_NODE * max(n_union, 1):
        return "bsr"
    return "dense"


def make_backend(kind: str, *, shard_mode: str = "dual_blocked",
                 shard_devices: Optional[int] = None, bsr_block: int = 128,
                 bsr_fused: bool = True, device="cuda") -> SweepBackend:
    if kind == "dense":
        return DenseSweepBackend(device=device)
    if kind == "sharded":
        return ShardedSweepBackend(mode=shard_mode, n_devices=shard_devices,
                                   device=device)
    if kind == "bsr":
        return BsrSweepBackend(bs=bsr_block, fused=bsr_fused, device=device)
    raise ValueError(f"unknown backend {kind!r} (want one of {BACKENDS})")
