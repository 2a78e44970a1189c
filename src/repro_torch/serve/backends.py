"""Pluggable sweep backends for the query-ranking service (port of
``repro.serve.backends``).

``RankService`` assembles one padded union-subgraph batch per traversal —
(n_pad, V) start vectors, per-column induced Ca/Ch weights and base-set
masks, and a sentinel-padded edge list — and hands it to a backend that
runs the masked multi-column accelerated-HITS convergence loop:

* ``dense`` — ``core.hits.hits_sweep_cols`` on the deterministic segmented
              SpMV (``sparse.spmv``), a per-sweep torch loop.
* ``bsr``   — the hand-written BSR kernels (``kernels.bsr_spmm``) after
              the blocking permutation; the loop runs on the device by
              default (``kernels.bsr_converge_cols``), ``fused=False``
              keeps the host-driven loop as its parity reference.

The mesh-``sharded`` backend is not ported yet (ROADMAP, Queue 1 item 8).

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
from ..kernels.ops import DeviceBSR, bsr_converge, bsr_matvec
from ..runtime import dtype_name, resolve_device, tol_in, torch_dtype
from ..sparse.spmv import normalize_l1
from .plans import BsrPlan, DensePlan, SweepPlan, structure_key

BACKENDS = ("dense", "sharded", "bsr")
SHARDED_TODO = "ROADMAP.md Queue 1 item 8 (multi-device)"

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


def _record_ready(dev: torch.device):
    """An event after everything enqueued so far on ``dev`` (None on CPU)."""
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(dev))
    return ev


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

    def _check(self, plan: SweepPlan, batch: SweepBatch):
        if plan.backend != self.name or plan.n_pad != batch.h0.shape[0]:
            raise ValueError(
                f"plan {plan.backend!r}/n_pad={plan.n_pad} does not fit "
                f"batch {self.name!r}/n_pad={batch.h0.shape[0]}")
        if plan.ready is not None:  # built on another thread's stream
            torch.cuda.current_stream(self.device).wait_event(plan.ready)

    def _tensors(self, b: SweepBatch):
        """The batch's (h0, ca, ch, mask) on the device at the sweep dtype."""
        dt = torch_dtype(b.dtype)
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(
            self.device, dt) for x in (b.h0, b.ca, b.ch, b.mask))


def _numpy(*ts):
    return tuple(t.cpu().numpy() for t in ts)


# ------------------------------------------------------------------- dense


def _converge_dense(edges: EdgeList, h0, ca, ch, mask, tol: float,
                    max_iter: int, rank_k: int = 0, stable_sweeps: int = 2,
                    bulk_dtype=None, bulk_tol: float = 0.0):
    """Convergence loop for V masked columns (the reference's
    ``_converge_batch``): per-column L1 residual and optional rank
    stability, the ladder's bulk phase first when ``bulk_dtype`` is set
    (``max_iter`` bounds the total, rank state resets at the switch), and
    one extra full-precision sweep for the certificate."""
    sweep = hits_sweep_cols(edges, ca, ch, mask)
    k_eff = min(int(rank_k), h0.shape[0]) if rank_k else 0
    v = h0.shape[1]
    i32 = dict(dtype=torch.int32, device=h0.device)

    def loop(sweep_fn, h, k, stop_tol):
        conv = torch.full((v,), -1, **i32)
        top_prev = torch.full((v, k_eff), -1, **i32)
        stab = torch.zeros(v, **i32)
        while k < max_iter and bool((conv < 0).any()):
            h_new, a = sweep_fn(h)
            delta = (h_new - h).abs().sum(dim=0)
            stop = delta.double() <= tol_in(stop_tol, delta.dtype)
            if k_eff:
                top = _topk_rows(a, k_eff)
                stab = torch.where((top == top_prev).all(dim=1), stab + 1, 0)
                stop = stop | (stab >= stable_sweeps)
                top_prev = top
            conv = torch.where((conv < 0) & stop, k + 1, conv)
            h, k = h_new, k + 1
        return h, k, conv

    k = 0
    if bulk_dtype is not None:
        bd = torch_dtype(bulk_dtype)
        sweep_lo = hits_sweep_cols(edges.astype(bd), ca.to(bd), ch.to(bd),
                                   mask.to(bd))
        h_lo, k, _ = loop(sweep_lo, h0.to(bd), k, bulk_tol)
        h0 = h_lo.to(h0.dtype)
    h, k, conv = loop(sweep, h0, k, tol)
    conv = torch.where(conv < 0, k, conv)
    h2, a = sweep(h)
    res = (h2 - h).abs().sum(dim=0)
    return h, normalize_l1(a, axis=0), conv, res


class DenseSweepBackend(SweepBackend):
    """Single-device gather/segmented-sum path (the semantic reference)."""

    name = "dense"

    def _edges(self, src, dst, w, n_pad: int, dtype) -> EdgeList:
        t = lambda x, dt: torch.from_numpy(np.ascontiguousarray(x)).to(  # noqa: E731
            self.device, dt)
        return EdgeList.build(t(src, torch.int64), t(dst, torch.int64), n_pad,
                              t(w, torch_dtype(dtype)))

    def plan(self, b: SweepBatch, key: str = "") -> DensePlan:
        n_pad = b.h0.shape[0]
        return DensePlan(key=key or b.structure_key(), backend=self.name,
                         n_pad=n_pad,
                         edges=self._edges(b.src, b.dst, b.w, n_pad, b.dtype),
                         ready=_record_ready(self.device))

    def plan_arrays(self, plan: DensePlan):
        e = plan.edges
        return ({"src": e.src.int().cpu().numpy(),
                 "dst": e.dst.int().cpu().numpy(),
                 "w": e.w.cpu().numpy()}, {"n_pad": int(plan.n_pad)})

    def plan_restore(self, key: str, arrays, meta) -> DensePlan:
        n_pad = int(meta["n_pad"])
        w = np.asarray(arrays["w"])
        return DensePlan(key=key, backend=self.name, n_pad=n_pad,
                         edges=self._edges(arrays["src"], arrays["dst"], w,
                                           n_pad, w.dtype),
                         ready=_record_ready(self.device))

    def sweep(self, plan: DensePlan, b: SweepBatch):
        self._check(plan, b)
        h0, ca, ch, m = self._tensors(b)
        out = _converge_dense(plan.edges, h0, ca, ch, m, b.tol, b.max_iter,
                              rank_k=int(b.rank_k),
                              stable_sweeps=int(b.stable_sweeps),
                              bulk_dtype=b.bulk_dtype, bulk_tol=b.bulk_tol())
        return _numpy(*out)


# --------------------------------------------------------------------- bsr


class BsrSweepBackend(SweepBackend):
    """Block-sparse kernel path for the dense-block regime.

    The union subgraph is renumbered by ``core.reordering``'s blocking
    permutation (non-dangling pages first, degree-descending) so structural
    nonzeros cluster into dense (bs x bs) blocks, then each half-step is one
    K1 launch with the column's induced diagonal fused in. The loop runs on
    the device by default (``kernels.bsr_converge_cols``: one host read of
    the stop flag per chunk of sweeps); ``fused=False`` keeps the
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
              lfwd: DeviceBSR, accum: str, bulk) -> BsrPlan:
        lt_lo = lfwd_lo = None
        if bulk:
            # ladder: low-precision operator copies share the idx arrays;
            # only the block values are cast (the bulk phase's working set)
            lt_lo, lfwd_lo = lt.astype(bulk), lfwd.astype(bulk)
        as_dev = lambda p: torch.from_numpy(p.astype(np.int64)).to(  # noqa: E731
            self.device)
        return BsrPlan(key=key, backend=self.name, n_pad=n_pad,
                       perm=perm, inv=inv, perm_dev=as_dev(perm),
                       inv_dev=as_dev(inv), lt=lt, lfwd=lfwd, bs=lt.bs,
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
                  "lt_blocks": plan.lt.blocks.cpu().numpy(),
                  "lt_idx": plan.lt.idx.cpu().numpy(),
                  "lfwd_blocks": plan.lfwd.blocks.cpu().numpy(),
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


def select_backend(n_union: int, e_union: int, n_devices: int = 1,
                   cuda: Optional[bool] = None) -> str:
    """The ``auto`` heuristic: pick a backend from subgraph density and
    device count.

    Multi-device hosts shard once the union subgraph carries enough edges
    to amortize per-sweep collectives; single-device dense-block subgraphs
    take the BSR kernels when the device is CUDA (their plain versions on
    the CPU would serve slower than the dense path); everything else stays
    dense.
    """
    if cuda is None:
        cuda = torch.cuda.is_available()
    if n_devices > 1 and e_union >= _SHARD_MIN_EDGES:
        return "sharded"
    if cuda and e_union >= _BSR_MIN_EDGES_PER_NODE * max(n_union, 1):
        return "bsr"
    return "dense"


def make_backend(kind: str, *, bsr_block: int = 128, bsr_fused: bool = True,
                 device="cuda") -> SweepBackend:
    if kind == "dense":
        return DenseSweepBackend(device=device)
    if kind == "sharded":
        raise NotImplementedError(
            f"the sharded backend is not ported yet: {SHARDED_TODO}")
    if kind == "bsr":
        return BsrSweepBackend(bs=bsr_block, fused=bsr_fused, device=device)
    raise ValueError(f"unknown backend {kind!r} (want one of {BACKENDS})")
