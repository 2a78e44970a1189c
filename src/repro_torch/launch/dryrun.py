"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step on
``meta`` tensors and price its per-device roofline terms (port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell over 512 forced XLA host
devices and reads FLOPs, bytes and collectives from the HLO. Torch has
no HLO, so the port runs the step itself, allocating nothing:

* **Model cells** (LM, GNN, recsys). A ``fake`` process group whose
  world is the mesh's size (rank 0 is this process), a ``DeviceMesh`` of
  the production mesh's shape and axis names, and every argument a
  ``DTensor`` over ``meta`` shards, placed by its spec: the reference's
  ``filter_spec`` then ``_divisible_spec``, each named axis a ``Shard``
  and the rest ``Replicate``. DTensor propagates the shardings;
  ``ShardedCost`` counts rank 0's local ops and makes every
  redistribution itself, so the counts do not follow DTensor's own
  choices, which differ between torch versions: the models' hints
  (``shard_hint``, ``shard_like``; a dim the hint's axis does not divide
  sharded as XLA pads it, a hint on a product's output carried back to
  the product), a partial sum reduced where a non-linear op consumes it
  (XLA's choice), views that keep the shards of the dims they merge or
  split, and its own rules for products, lookups, scatters, sorts,
  slices, pads and diagonals; a checkpointed layer's recompute and
  backward gather each FSDP weight once (``ShardedCost.recompute``), and
  the products of a hint's gathered operand split along its shards from
  before the gather (the two-tower's in-batch backward). Where
  grouped-query heads split the model axis's shards across two dims, the
  axis is factored into two mesh dims (``model_axis_factors``). A
  collective DTensor would still choose is listed in the cell's
  ``dtensor_choices``; ``strict`` makes it an error. The group lives
  inside ``run_cell`` and is destroyed on the way out.
* **Ranking cells.** ``make_dryrun_rank_sweep`` (the reference's lives
  in ``sparse/dist.py``) runs the sweep's modes over a
  ``sparse.dist.Mesh`` of ``meta`` devices, one process over every
  shard: per-device FLOPs and bytes are shard 0's ops, collective bytes
  the mesh's counters, which count each collective once (the
  reference's ``hlo_analysis.collective_bytes`` counts the entry
  computation twice).

Everything runs on the host CPU; the roofline is priced at ``--hw``
(default ``h100-sxm``: data-sheet rates, not measurements). Each cell
writes the reference's JSON (``status``, ``meta``, ``roofline``,
``collectives``, ``memory``), so ``benchmarks/roofline_report.py`` reads
either package's output; ``compile_s`` is the cell's wall seconds here
(nothing is compiled).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-7b \\
      --shape train_4k --mesh pod1 --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --include-ranking --mesh pod1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gin-tu \\
      --shape ogb_products --mesh host --device cuda  # one card, unsharded
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
from torch import nn
from torch.utils._pytree import tree_flatten, tree_map_only

from ..configs import REGISTRY, get_spec
from ..models.sharding import DP, P, axis_of, filter_spec, placements
from ..sparse.dist import Mesh, all_gather, psum
from ..tree import leaves, tree_map
from . import hlo_analysis
from .hlo_cost import _C10D, _COLLECTIVES, StepCost, _is_fake
from .mesh import make_host_mesh, make_production_mesh
from .steps import build_step

_MOVED = {"all-reduce": 2.0}  # ring model: an all-reduce moves 2x its output


def _axis_size(a, sizes: dict) -> int:
    if a is None:
        return 1
    if isinstance(a, (tuple, list)):
        n = 1
        for x in a:
            n *= sizes.get(x, 1)
        return n
    return sizes.get(a, 1)


def _divisible_spec(spec, shape, mesh) -> P:
    """Drop sharding on dims the mesh axes don't divide (B=1 decode, 24
    heads over model=16, 429-dim cross layers, ...). Correctness first;
    the roofline records what replication costs."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    out = []
    for i, a in enumerate(spec):
        if i >= len(shape):
            out.append(None)
            continue
        size = _axis_size(a, sizes)
        out.append(a if size > 1 and shape[i] % size == 0 else
                   (a if size == 1 else None))
    return P(*out)


# ---------------------------------------------------------------- model cells
@contextlib.contextmanager
def _relaxed_views():
    """DTensor's ``view`` and ``_unsafe_view`` may redistribute their
    input, as ``reshape`` may, restored on exit: a product's output can
    come sharded along a flattened (heads x head_dim) axis that the
    following unflatten cannot split evenly (8 KV heads over model=16),
    and DTensor's strict view refuses where a real run would gather."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops._view_ops import \
        register_op_strategy_map
    aten = torch.ops.aten
    prop = DTensor._op_dispatcher.sharding_propagator
    ops = {aten.view.default: torch.Tensor.view,
           aten._unsafe_view.default: torch.Tensor.view}
    saved = {op: (prop.op_strategy_funcs[op], prop.op_to_schema_info.get(op))
             for op in ops}
    try:
        for op, local in ops.items():
            register_op_strategy_map(op, local, schema_info=saved[op][1],
                                     strict_view=False)
        prop.propagate_op_sharding.cache_clear()
        yield
    finally:
        for op, (fn, info) in saved.items():
            prop.op_strategy_funcs[op] = fn
            if info is not None:
                prop.op_to_schema_info[op] = info
        prop.propagate_op_sharding.cache_clear()


class ShardedCost(StepCost):
    """``StepCost`` for the model cells: it makes the step's
    redistributions itself, as XLA's SPMD partitioner would, and counts
    their collectives (DTensor's own choices differ between torch
    versions: masked partials that cannot be redistributed later,
    strategies missing or failing on index lists with ``None``, a cost
    model that picks other collectives):

    * ``redistribute``: the models' ``shard_hint`` and ``shard_like``
      (through ``models.sharding.REDISTRIBUTE`` while the mode is
      entered), counted by ``localize``; a dim that a hint's axis does
      not divide is sharded as XLA pads it (ceil(n / k) rows a device,
      a gather k x ceil(n / k), a partial sum all-reduced whole), and a
      hint on a product's output is carried back to the product
      (``_carry``); where DTensor would still redistribute an uneven
      shard, its uneven dims are gathered first;
    * a partial operand of any op but a linear one over operands placed
      alike (``_LINEAR``) is all-reduced first;
    * a view keeps the shards of the dims it merges or splits
      (``_view_placements``): an einsum's product over a (batch, heads)
      batch sharded on data and model;
    * a lookup in a table sharded by rows, with indices not sharded on
      that mesh dim: each device looks the indices up in its own rows and
      the outputs are all-reduced (a masked lookup); where the indices
      are sharded, the table is gathered first;
    * its backward: each device scatters its output gradient into the
      table's gradient, placed as the table was in the lookup where the
      table's rows are sharded (a gradient sharded along the positions
      replicated first by an all-reduce, as XLA transposes a masked
      gather), partial where the indices are sharded;
    * a scatter (``index_add``, ``index_copy``, ``index_put``,
      ``scatter``, ``scatter_add``) runs on the target's shards: its index
      is replicated, its updates sharded as the target along the dims the op
      does not index and replicated elsewhere (each shard applies the
      updates that land in it, as a KV-cache write into a
      position-sharded cache); a replicated target takes the shards of
      updates sharded along a dim it does not index; a partial target,
      ``searchsorted`` and ``bincount`` replicate their inputs first;
    * a constant pad gathers the dims it pads; a diagonal's backward
      keeps the gradient's shards; leaky_relu and its backward run on the
      shards of operands placed alike;
    * a softmax along a sharded dim normalizes each slice, its max and
      sum all-reduced (``_softmax``);
    * ``mm`` and ``bmm`` as XLA places a dot (``_matmul``): a batch or
      contraction sharded alike, a replicated operand sliced to the
      other's shards (but an FSDP weight, sharded along the contraction
      over a data axis, gathered where its partial product's all-reduce
      would move more), and where the two are sharded along different
      roles on one mesh dim, the one sharded along the contraction (an
      FSDP weight) or else the smaller (decode's queries against the
      cache's positions) gathered;
    * a sort gathers its dim (``_sort``); a diagonal of a row-sharded
      square takes each device's own rows (``_diagonal``); a slice along
      a sharded dim keeps each device's even share, a collective-permute
      moving the shares that lie on another device (``_slice``, and its
      backward); ``x[idx]`` is a lookup as ``embedding`` is (``_index``);
      a lookup whose ids and rows share a mesh dim gathers the ids;
    * operands of one shape sharded along different dims on a mesh dim
      take the first's shards (a pointwise op: decode's residual add);
    * the gradient of a redistribution that only sliced stays sharded,
      and a lookup's backward with a gradient sharded along the looked-up
      positions of a replicated table scatters into a partial gradient
      of the whole table;
    * a weight (a view of a parameter's shard: ``weights``) gathered in
      a checkpointed layer's recompute is kept for the layer's backward
      (``recompute``, entered through ``models.sharding.RECOMPUTE``):
      one gather for the recomputed forward and the backward products,
      as XLA's backward loop body gathers it;
    * a hint that moves a dim's shards from some mesh dims to others
      (the two-tower's items onto the model axis) is one
      collective-permute of the new shard, and its gradient moves back;
    * a product one of whose operands a hint gathered, along a dim its
      shards from before the gather split, where the other operand is
      replicated there, runs on those shards into a partial sum,
      all-reduced at once (``_presplit``: the two-tower's ``g @ v``);
      the gradient of such a gather is carried back to the product
      that makes it, which computes only the device's share
      (``_carry``'s "slice": ``u.T @ g``); a product's partial output
      stays partial through a transpose.

    Any other collective is DTensor's choice: recorded in ``implicit``
    by op and kind, and refused under ``strict``."""

    def __init__(self, strict: bool = False):
        super().__init__()
        self.lookups = {}  # id(indices) -> the table's placements
        self.strict = strict
        # (op, kind) -> output bytes of the collectives DTensor chose itself
        self.implicit = {}
        self._op = None
        self._declined = None
        self._probe = False    # DTensor's choices raise _Probe
        self.merges = {}   # a view's merged dims, for the split undoing it
        # a product's local output's storage (its views share it) -> (it,
        # {mesh dim: the other placement it could have taken there}), for
        # a hint carried back to the product (``_carry``)
        self.products = {}
        # the storages of the parameters' shards -> the shard
        # (``weight_key``)
        self.weights = {}
        # from the start of a checkpointed layer's recompute through its
        # backward (``recompute``): the (weight key, mesh dim) of every
        # weight gathered there, which ``localize`` redistributes again at
        # no cost
        self.memo = None
        self._depth = 0
        # a hint's gathered output's key (``_key``) -> (it, the placements
        # it had, its global shape): ``_matmul`` contracts along those
        # shards where they shard the contraction
        self.gathered = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _is_fake() or not any(issubclass(t, _dtensor()) for t in types):
            return super().__torch_dispatch__(func, types, args, kwargs)
        rule = _RULES.get(func._overloadpacket)
        if self._declined is func:   # a rule left it to DTensor
            rule, self._declined = None, None
        if rule is not None:
            return rule(self, func, args, kwargs)
        dts = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, _dtensor())]
        partial = any(p.is_partial() for a in dts for p in a.placements)
        if partial and _transpose(func, args):
            # a product's partial output stays partial through a transpose
            # (the gradient of ``u @ v.T``'s ``v``), reduced where XLA
            # would: at the hint's gradient, after ``_carry``
            from torch.distributed.tensor import Shard
            x = args[0]
            pl = [Shard(1 - p.dim) if p.is_shard() else p
                  for p in x.placements]
            return _wrap(self.run(func, (x._local_tensor,) + tuple(args[1:]),
                                  kwargs), x.device_mesh, pl,
                         (x.shape[1], x.shape[0]))
        if partial and not (
                func._overloadpacket in _LINEAR and
                all(a.placements == dts[0].placements for a in dts) and
                len(dts) == len([a for a in args[:2] if isinstance(
                    a, (torch.Tensor, float, int))])):
            args, kwargs = tree_map_only(_dtensor(), self.reduce_partial,
                                         (args, kwargs))
            with self:
                return func(*args, **kwargs)
        uneven = not self._probe and _uneven(dts)
        tensors = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
        # an uneven shard's operands, all of its shape (a plain tensor
        # counts as replicated), placed apart on some mesh dim
        plain = uneven and all(t.shape == dts[0].shape for t in tensors) \
            and len(tensors) > 1
        if torch.Tag.pointwise in func.tags and all(
                a.shape == dts[0].shape for a in dts) and any(
                len({p.dim for p in ps if p.is_shard()}) > 1 or
                plain and (len(set(ps)) > 1 or len(dts) < len(tensors))
                for ps in zip(*(a.placements for a in dts))):
            # operands of one shape sharded along different dims on a mesh
            # dim (decode's residual add of a feature-sharded product), or
            # beside an uneven shard (decode's one token over data=16):
            # each mesh dim takes the first operand's shards there, the
            # others sliced to them
            from torch.distributed.tensor import Replicate
            mesh = dts[0].device_mesh
            want = [next((p for p in ps if p.is_shard()), ps[0])
                    for ps in zip(*(a.placements for a in dts))]

            def place(a):
                if not isinstance(a, _dtensor()):
                    if not plain:
                        return a
                    a = _wrap(a.to("meta"), mesh, [Replicate()] * mesh.ndim)
                return self.redistribute(a, want)
            args, kwargs = tree_map_only(torch.Tensor, place, (args, kwargs))
            with self:
                return func(*args, **kwargs)
        if uneven:
            # where DTensor would redistribute an uneven shard itself (a
            # mean over decode's one token padded over data=16), the
            # uneven dims are gathered first, as XLA gathers a padded dim
            # it cannot reduce in place
            self._probe = True
            try:
                return _to_dtensor(self, func, args, kwargs)
            except _Probe:
                pass
            finally:
                self._probe = False
            args, kwargs = tree_map_only(_dtensor(), self.gather_uneven,
                                         (args, kwargs))
            return _to_dtensor(self, func, args, kwargs)
        self._op = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def gather_uneven(self, x):
        """``x`` with the mesh dims that shard a dim unevenly gathered."""
        from torch.distributed.tensor import Replicate
        want = [Replicate() if _uneven_at(x, p) else p
                for p in x.placements]
        return x if want == list(x.placements) else \
            self.redistribute(x, want)

    def reduce_partial(self, x):
        """``x`` with its partial mesh dims all-reduced, as XLA reduces a
        partial dot output where a non-linear op consumes it."""
        from torch.distributed.tensor import Replicate
        return self.redistribute(x, [Replicate() if p.is_partial() else p
                                     for p in x.placements])

    def _count(self, func, args, kwargs, out):
        if func.namespace in _C10D and _COLLECTIVES.get(func._opname):
            if self._probe:
                raise _Probe
            kind = _COLLECTIVES[func._opname]
            key = (str(self._op), kind)
            b = float(sum(t.numel() * t.element_size()
                          for t in tree_flatten(out)[0]
                          if isinstance(t, torch.Tensor)))
            self.implicit[key] = self.implicit.get(key, 0.0) + b
            if self.strict:
                raise RuntimeError(
                    f"DTensor chose a {kind} for {self._op}: the dry-run "
                    "pins every redistribution (shard_hint or its rules)")
        super()._count(func, args, kwargs, out)

    def run(self, func, args, kwargs):
        out = func(*args, **kwargs)
        if self.counting:
            self._count(func, args, kwargs, out)
        return out

    def hold_weights(self, tensors):
        """Mark ``tensors`` (the step's parameters) as weights: views of
        their shards (a layer's slice of a stacked weight) are what a
        layer's recompute gathers once for its backward (``recompute``).
        A cast makes another tensor, not a weight: the configs that shard
        weights FSDP-style keep them in the compute dtype."""
        for t in tensors:
            loc = t._local_tensor
            self.weights[_storage(loc)] = loc

    def weight_key(self, x):
        """A weight's key (its shard's storage, offset and size: every
        view of one layer's weight has it), or None for any other
        tensor."""
        if not isinstance(x, _dtensor()):
            return None
        loc = x._local_tensor
        return _key(loc) if _storage(loc) in self.weights else None

    @contextlib.contextmanager
    def recompute(self):
        """Entered where a checkpointed layer's recompute begins
        (``models.sharding.RECOMPUTE``): a new memo of gathered weights,
        kept through the layer's backward, as XLA's backward loop body
        gathers each FSDP weight once for its rematerialized forward and
        its transposes (FSDP2's unshard in a backward pre-hook): a weight
        the memo holds gathered on a mesh dim is redistributed there at
        no cost (``localize``). The forward's own gathers are not kept:
        the checkpoint saves nothing."""
        self.memo = set()
        yield

    def localize(self, x, want, mesh, key=None):
        """``x``'s local tensor at placements ``want`` (``meta``),
        counting the collectives of the redistribution: partial to
        replicated an all-reduce (one over every such mesh dim), partial
        to sharded a reduce-scatter (an all-reduce where the dim is
        sharded unevenly), sharded to replicated an all-gather,
        sharded along another dim an all-to-all; replicated to sharded
        is a local slice. A dim that its mesh dims do not divide is
        sharded as XLA pads it: each shard ceil(n / k) (rank 0's, the one
        counted), a gather's output k x ceil(n / k), the padding sliced
        off after. ``key``: ``x`` is that weight (``weight_key``); a mesh
        dim the recompute's memo holds it gathered on moves nothing, and
        one gathered here goes into the memo."""
        if not isinstance(x, _dtensor()):
            return x
        shape = list(x._local_tensor.shape)
        cur = list(x.placements)
        item = x.element_size()
        # one all-reduce over every partial mesh dim, where any of them
        # ends unsharded or sharded unevenly (XLA all-reduces the whole,
        # then pads and slices): a dim that ends sharded takes its slice
        reduced = any(p.is_partial() and mesh.size(d) > 1 and (
            not q.is_shard() or shape[q.dim] % mesh.size(d))
            for d, (p, q) in enumerate(zip(x.placements, want)))
        if reduced:
            self.add_collective("all-reduce", _numel(shape) * item)
        for _t, src, dst in _moves(x, want):
            # a dim's shards moved from some mesh dims to others (the
            # two-tower's items onto the model axis, and their gradient
            # back): one collective-permute of the new shard, as XLA
            # moves it
            for d in src + dst:
                cur[d] = want[d]
            shape = _local_shape(x.shape, cur, mesh)
            self.add_collective("collective-permute", _numel(shape) * item)
        memo = self.memo if key is not None else None
        for dims in _axis_dims(mesh):   # one collective per axis and kind
            before = list(shape)
            kinds = set()
            for d in dims:
                p, q, n = cur[d], want[d], mesh.size(d)
                cur[d] = q
                if p == q or n == 1:
                    continue
                if memo is not None and p.is_shard() and (key, d) in memo:
                    shape[p.dim] *= n        # the memo's gather, sliced
                    if q.is_shard():
                        shape[q.dim] = -(-shape[q.dim] // n)
                    continue
                if p.is_partial():
                    if q.is_shard():
                        shape[q.dim] = -(-shape[q.dim] // n)
                        if not reduced:
                            kinds.add("reduce-scatter")
                elif p.is_shard():
                    shape[p.dim] *= n
                    if q.is_shard():
                        shape[q.dim] = -(-shape[q.dim] // n)
                    kinds.add("all-to-all" if q.is_shard() else "all-gather")
                elif q.is_shard():
                    shape[q.dim] = -(-shape[q.dim] // n)
            for kind in sorted(kinds):
                self.add_collective(kind, _numel(shape) * item,
                                    _numel(before) * item)
            shape = _local_shape(x.shape, cur, mesh)
        if memo is not None:
            # a weight gathered in a recompute or its backward: kept
            memo.update((key, d) for d, (p, q) in enumerate(
                zip(x.placements, want)) if p.is_shard() and q.is_replicate())
        out = torch.empty(shape, dtype=x.dtype, device="meta")
        key = _storage(x._local_tensor)
        if key in self.products and all(
                p == q or p.is_partial() and q.is_replicate()
                for p, q in zip(x.placements, want)):
            # a product's partial sum reduced (before a permute) is still
            # its output for ``_carry``
            self.products[_storage(out)] = self.products.pop(key)
        return out

    def redistribute(self, x, want, hint=False, carry=()):
        """``x`` at placements ``want`` (``shard_hint``, ``shard_like``
        and the partial sums the dry-run reduces), counted by
        ``localize``; differentiable, as ``DTensor.redistribute`` is. A
        ``hint`` is first carried back to the product that made ``x``
        (``_carry``: a gather or a swap; ``carry`` names the kinds
        otherwise). A hint that gathers ``x`` records its output with
        the placements it had (``gathered``, for ``_matmul``)."""
        want = list(want)
        if torch.is_grad_enabled() and x.requires_grad:
            return _Redistribute.apply(x, want, self, hint)
        carry = _HINT if hint else carry
        if carry:
            x = self._carry(x, want, carry)
        out = _wrap(self.localize(x, want, x.device_mesh), x.device_mesh,
                    want, x.shape)
        if hint:
            self._gathered(x, out)
        return out

    def _gathered(self, x, out):
        """Record ``out``, a hint's output, where the hint gathered ``x``
        on some mesh dim (not a move, ``_moves``): its shard's key ->
        (it, the placements ``x`` had, its global shape). Whether it
        did."""
        moved = {d for _t, src, dst in _moves(x, out.placements)
                 for d in src + dst}
        if any(p.is_shard() and q.is_replicate() and d not in moved
               for d, (p, q) in enumerate(zip(x.placements,
                                              out.placements))):
            loc = out._local_tensor
            self.gathered[_key(loc)] = (loc, list(x.placements),
                                        tuple(x.shape))
            return True
        return False

    def _carry(self, x, want, kinds=None):
        """A hint on a product's output carried back to the product, as
        XLA's propagation gives a dot its constraint's placement and
        partitions the dot to produce it. On a mesh dim where the output's
        shards came from one operand's free dim only: a hint that gathers
        it gathers that operand instead and computes the product whole
        along the dim, where that moves fewer bytes (MoE's second expert
        product in training: w2 gathered, FSDP, not the (E, C, d)
        output); a hint that wants the other operand's free dim sharded
        there, where the product gathered that other operand (the smaller
        of two sharded apart), gathers the first one instead (MoE decode:
        w2 gathered, not the tokens' activations, and no all-to-all). A
        "slice" (the gradient of a hint's gather, going back to the
        gathered value's shards): where the product's output is
        replicated on a mesh dim and the hint wants it sharded there,
        the product computes only this device's share (the two-tower's
        ``u.T @ g`` only the device's own item rows). ``kinds``: those
        carried (a hint's: gather and swap). Returns ``x`` at its new
        placements."""
        from torch.distributed.tensor import Replicate
        loc = x._local_tensor
        rec = self.products.pop(_storage(loc), None)
        if rec is None:
            return x
        mesh, pl = x.device_mesh, list(x.placements)
        out_b = loc.numel() * loc.element_size()
        for d, (kind, counted, gather, flops, hbm, key) in rec[1].items():
            n, p, q = mesh.size(d), pl[d], want[d]
            if kind not in (kinds or _HINT):
                continue
            if kind == "slice":
                # ``gather`` is the product's global output shape, ``hbm``
                # its (a, b, output) local bytes
                o = _same_dim(gather, x.shape, q.dim) \
                    if p.is_replicate() and q.is_shard() and \
                    x.shape[q.dim] % n == 0 else None
                if o is None:
                    continue
                role = "bmn"[-len(gather):][o]
                part = hbm[2] + hbm[0] * (role in "bm") + \
                    hbm[1] * (role in "bn")
                self.flops -= flops * (n - 1) / n
                self.bytes -= part * (n - 1) / n
                pl[d] = q
                continue
            if not p.is_shard() or (q.is_shard() if kind == "gather" else
                                    not q.is_shard() or q.dim == p.dim):
                continue
            # a weight a recompute already gathered costs nothing more
            held = kind == "gather" and self.memo is not None and \
                key is not None and (key, d) in self.memo
            if kind == "gather" and gather >= out_b and not held:
                continue
            if kind == "gather" and self.memo is not None and \
                    key is not None:
                self.memo.add((key, d))
            if not held:
                self.add_collective("all-gather", gather * n - counted)
            if counted:       # it replaces the gather the product made
                self.n_collective_ops -= 1
            self.flops += flops * (n - 1)
            self.bytes += hbm * (n - 1)
            pl[d] = Replicate() if kind == "gather" else q
        if pl != list(x.placements):
            x = _wrap(torch.empty(_local_shape(x.shape, pl, mesh),
                                  dtype=x.dtype, device="meta"), mesh, pl,
                      x.shape)
        return x

    def __enter__(self):
        from ..models import sharding
        self._saved_hook = sharding.REDISTRIBUTE, sharding.RECOMPUTE
        sharding.REDISTRIBUTE = lambda x, want: self.redistribute(x, want,
                                                                  True)
        sharding.RECOMPUTE = self.recompute
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        from ..models import sharding
        sharding.REDISTRIBUTE, sharding.RECOMPUTE = self._saved_hook
        self._depth -= 1
        if not self._depth:
            self.memo = None
        return super().__exit__(*exc)


_HINT = ("gather", "swap")   # what a hint carries back to its product


def _key(loc):
    """A shard's key: its storage, offset and size (its views that keep
    every element, a transpose among them, share it)."""
    return _storage(loc), loc.storage_offset(), loc.numel()


def _same_dim(shape, of, dim):
    """Dim ``dim`` of a tensor of global shape ``of``, in a view of it of
    global ``shape``: the same tensor or its transpose (a matrix); None
    for any other view."""
    if tuple(shape) == tuple(of):
        return dim
    if len(shape) == 2 and tuple(shape) == tuple(of)[::-1]:
        return 1 - dim
    return None


def _moves(x, want):
    """The tensor dims of DTensor ``x`` whose shards move from some mesh
    dims to others at placements ``want``, each new shard inside one old
    one or made of whole old ones, evenly: (dim, source mesh dims,
    target mesh dims)."""
    mesh, out = x.device_mesh, []
    for t in range(x.dim()):
        src = [d for d, p in enumerate(x.placements)
               if p.is_shard(t) and mesh.size(d) > 1]
        dst = [d for d, q in enumerate(want)
               if q.is_shard(t) and mesh.size(d) > 1]
        ns = _numel([mesh.size(d) for d in src])
        nd = _numel([mesh.size(d) for d in dst])
        if src and dst and not set(src) & set(dst) and \
                (ns % nd == 0 or nd % ns == 0) and \
                x.shape[t] % max(ns, nd) == 0 and \
                all(want[d].is_replicate() for d in src) and \
                all(x.placements[d].is_replicate() for d in dst):
            out.append((t, src, dst))
    return out


class _Probe(Exception):
    """DTensor would choose a collective (``ShardedCost._probe``)."""


# ops that keep a partial input partial when every DTensor operand has
# the same placements (a sum of partials, a cast, a reduction over it)
_LINEAR = {torch.ops.aten.add, torch.ops.aten.add_, torch.ops.aten.sub,
           torch.ops.aten.neg, torch.ops.aten.sum, torch.ops.aten.clone,
           torch.ops.aten._to_copy, torch.ops.aten.copy_}


def _transpose(func, args) -> bool:
    """Whether ``func`` transposes a matrix."""
    packet = func._overloadpacket
    return packet is torch.ops.aten.t or (
        packet is torch.ops.aten.permute and args[0].dim() == 2
        and list(args[1]) == [1, 0])


class _Redistribute(torch.autograd.Function):
    """``ShardedCost.redistribute`` under autograd: the gradient goes
    back to the input's placements (a partial input's as replicated, as
    ``DTensor.redistribute``'s backward does), counted the same way."""

    @staticmethod
    def forward(ctx, x, want, cost, hint):
        from torch.distributed.tensor import Replicate
        ctx.cost = cost
        # where the forward only took a slice (replicated to sharded), the
        # gradient keeps its shards: a replicated value's gradient may lie
        # sharded (XLA places a cotangent so), and gathering it is waste;
        # a hint carried back to its product leaves the output's gradient
        # replicated there, as the product's output was; a hint that
        # moved a dim's shards to other mesh dims moves the gradient back
        if hint:
            x = cost._carry(x, want)
        back = [q if p.is_replicate() and q.is_shard() else
                Replicate() if p.is_partial() else p
                for p, q in zip(x.placements, want)]
        for _t, src, dst in _moves(x, want):
            for d in src + dst:
                back[d] = x.placements[d]
        ctx.back = back
        out = _wrap(cost.localize(x, want, x.device_mesh), x.device_mesh,
                    want, x.shape)
        # the gradient of a hint's gather is carried back to the product
        # that makes it, as a slice (``_carry``)
        ctx.carry = ("slice",) if hint and cost._gathered(x, out) else ()
        return out

    @staticmethod
    def backward(ctx, grad):
        return ctx.cost.redistribute(grad, ctx.back, carry=ctx.carry), \
            None, None, None


def _dtensor():
    from torch.distributed.tensor import DTensor
    return DTensor


def _storage(t):
    """The storage ``t`` and its views share (``meta`` has no data)."""
    return t.untyped_storage()._cdata


def _axis_dims(mesh):
    """The mesh dims of each mesh axis (an axis the dry-run factored
    spans consecutive dims: ``models.sharding.axis_of``)."""
    groups = {}
    for d, name in enumerate(mesh.mesh_dim_names):
        groups.setdefault(axis_of(name), []).append(d)
    return list(groups.values())


def _axes_over(mesh, dims) -> int:
    """How many mesh axes of more than one device the mesh dims ``dims``
    span (an all-reduce over them is one collective a axis)."""
    return len({axis_of(mesh.mesh_dim_names[d]) for d in dims
                if mesh.size(d) > 1})


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _placements_of(x, ndim):
    from torch.distributed.tensor import Replicate
    return list(x.placements) if isinstance(x, _dtensor()) \
        else [Replicate()] * ndim


def _local_shape(shape, pl, mesh):
    """Rank 0's shard of a tensor of global ``shape`` at placements
    ``pl``: ceil(n / k) along each sharded dim (``torch.chunk``'s first
    shard, XLA's padded one)."""
    out = list(shape)
    for d, p in enumerate(pl):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.size(d))
    return out


def _uneven_at(x, p) -> bool:
    """Whether placement ``p`` of DTensor ``x`` shards a dim that its mesh
    dims do not divide."""
    return p.is_shard() and x.shape[p.dim] % _numel(
        [x.device_mesh.size(e) for e, q in enumerate(x.placements)
         if q.is_shard(p.dim)]) != 0


def _uneven(tensors) -> bool:
    """Whether a DTensor among ``tensors`` is sharded unevenly."""
    return any(_uneven_at(x, p) for x in tensors
               if isinstance(x, _dtensor()) for p in x.placements)


def _global_out(func, args, kwargs):
    """``func``'s output at its DTensor operands' global shapes (``meta``,
    not counted): a rule's output's global shape where local x mesh size
    would be the padded size of an uneven shard."""
    dt = _dtensor()

    def glob(x):
        if isinstance(x, dt):
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        return x.to("meta") if isinstance(x, torch.Tensor) else x
    return func(*tree_map_only(torch.Tensor, glob, args),
                **tree_map_only(torch.Tensor, glob, kwargs))


def _wrap(local, mesh, pl, shape=None):
    """A DTensor of ``local`` shards at placements ``pl``; its global
    ``shape``, where not given, the shards' times the mesh dims' sizes
    (exact where they divide)."""
    if shape is None:
        shape = list(local.shape)
        for d, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.size(d)
    full = torch.empty(shape, device="meta")
    return _dtensor().from_local(local, mesh, pl, run_check=False,
                                 shape=full.shape, stride=full.stride())


def _embedding(cost, func, args, kwargs):
    from torch.distributed.tensor import Replicate
    weight, indices = args[0], args[1]
    mesh = next(a for a in args[:2] if isinstance(a, _dtensor())).device_mesh
    wpl = _placements_of(weight, mesh.ndim)
    ipl = _placements_of(indices, mesh.ndim)
    want_w, out_pl, reduce = [], [], []
    i_want = [p if p.is_shard() else Replicate() for p in ipl]
    for d, (wp, ip) in enumerate(zip(wpl, ipl)):
        if ip.is_shard() and wp.is_shard(0):
            # rows and ids split over one mesh dim (MoE's combine): every
            # device looks all the ids up in its own rows (the ids are
            # gathered), the outputs all-reduced, each keeping its share
            want_w.append(wp)
            i_want[d] = Replicate()
            out_pl.append(Replicate())
            reduce.append(d)
        elif ip.is_shard():
            want_w.append(Replicate())
            out_pl.append(ip)
        elif wp.is_shard(0):
            want_w.append(wp)
            out_pl.append(Replicate())
            reduce.append(d)
        elif wp.is_shard(1):
            want_w.append(wp)
            out_pl.append(type(wp)(indices.dim()))
        else:
            want_w.append(Replicate())
            out_pl.append(Replicate())
    cost.lookups[id(indices)] = want_w  # read by the backward
    w, i = cost.localize(weight, want_w, mesh), \
        cost.localize(indices, i_want, mesh)
    out = cost.run(func, (w, i) + tuple(args[2:]), kwargs)
    for _ in range(_axes_over(mesh, reduce)):
        cost.add_collective("all-reduce", out.numel() * out.element_size())
    shape = tuple(indices.shape) + tuple(weight.shape[1:])
    out = _wrap(out, mesh, out_pl, shape)
    keep = [ip if ip.is_shard() else p for p, ip in zip(out_pl, ipl)]
    return out if keep == out_pl else _wrap(
        cost.localize(out, keep, mesh), mesh, keep, shape)  # a slice


def _embedding_backward(cost, func, args, kwargs):
    from torch.distributed.tensor import Partial, Replicate
    grad, indices, num_weights = args[0], args[1], args[2]
    mesh = next(a for a in args[:2] if isinstance(a, _dtensor())).device_mesh
    ipl = _placements_of(indices, mesh.ndim)
    # the table's placements in the forward lookup (replicated if unseen)
    wpl = cost.lookups.get(id(indices), [Replicate()] * mesh.ndim)
    g_want, out_pl, rows = [], [], num_weights
    i_want = [p if p.is_shard() else Replicate() for p in ipl]
    gpl = _placements_of(grad, mesh.ndim)
    masked = []   # mesh dims on which the gradient is replicated
    for d, (ip, wp, gp) in enumerate(zip(ipl, wpl, gpl)):
        if wp.is_shard(0):
            # each device scatters the whole gradient into its own rows, as
            # XLA scatters the transpose of a masked gather (MoE's combine
            # and dispatch): a gradient sharded along the looked-up
            # positions is replicated as XLA replicates it, by a masked
            # gather of each device's positions and an all-reduce
            g_want.append(Replicate())
            i_want[d] = Replicate()
            out_pl.append(wp)
            rows = -(-rows // mesh.size(d))
            if gp.is_shard():
                masked.append(d)
        elif ip.is_shard():
            g_want.append(ip)
            out_pl.append(Partial())
        elif not wp.is_shard(1) and gp.is_shard() and \
                gp.dim < indices.dim():
            # the gradient arrives sharded along the looked-up positions
            # of a replicated table: each device adds its positions' rows
            # into a partial gradient of the whole table, as XLA scatters
            # a sharded cotangent
            g_want.append(gp)
            i_want[d] = gp
            out_pl.append(Partial())
        elif wp.is_shard(1):
            g_want.append(type(wp)(grad.dim() - 1))
            out_pl.append(wp)
        else:
            g_want.append(Replicate())
            out_pl.append(Replicate())
    if masked:
        grad = cost.redistribute(grad, [gpl[d] if d in masked else p
                                        for d, p in enumerate(g_want)])
        g = torch.empty(_local_shape(grad.shape, g_want, mesh),
                        dtype=grad.dtype, device="meta")
        for _ in range(_axes_over(mesh, masked)):
            cost.add_collective("all-reduce", g.numel() * g.element_size())
    else:
        g = cost.localize(grad, g_want, mesh)
    i = cost.localize(indices, i_want, mesh)
    out = cost.run(func, (g, i, rows) + tuple(args[3:]), kwargs)
    return _wrap(out, mesh, out_pl, (num_weights, grad.shape[-1]))


def _index(cost, func, args, kwargs):
    """``x[idx]`` (one index tensor, on dim 0) placed as ``_embedding``
    places a lookup: rows sharded on a mesh dim where the index is
    replicated are looked up on each shard and the outputs all-reduced;
    where the index is sharded too, the rows are gathered first; the
    index's shards and x's other dims' shards carry over to the output.
    DTensor's rule for other index lists."""
    from torch.distributed.tensor import Replicate, Shard
    x, idx = args[0], list(args[1])
    dt = _dtensor()
    if len(idx) != 1 or idx[0] is None:
        return _to_dtensor(cost, func, args, kwargs)
    i = idx[0]
    mesh = next(a for a in (x, i) if isinstance(a, dt)).device_mesh
    xpl, ipl = _placements_of(x, mesh.ndim), _placements_of(i, mesh.ndim)
    if not isinstance(x, dt):
        x = _wrap(x.to("meta"), mesh, xpl)
    x = cost.reduce_partial(x)
    if any(ip.is_partial() or ip.is_shard() and xp.is_shard() and xp.dim > 0
           for xp, ip in zip(x.placements, ipl)):
        return _to_dtensor(cost, func, args, kwargs)
    want_x, out_pl, reduce = [], [], []
    for d, (xp, ip) in enumerate(zip(x.placements, ipl)):
        if ip.is_shard():
            want_x.append(Replicate())
            out_pl.append(ip)
        elif xp.is_shard(0):
            want_x.append(xp)
            out_pl.append(Replicate())
            reduce.append(d)
        elif xp.is_shard():
            want_x.append(xp)
            out_pl.append(Shard(i.dim() - 1 + xp.dim))
        else:
            want_x.append(Replicate())
            out_pl.append(Replicate())
    xl = cost.localize(x, want_x, mesh)
    il = cost.localize(i, [p if p.is_shard() else Replicate() for p in ipl],
                       mesh) if isinstance(i, dt) else i.to("meta")
    out = cost.run(func, (xl, [il]), kwargs)
    for _ in range(_axes_over(mesh, reduce)):
        cost.add_collective("all-reduce", out.numel() * out.element_size())
    return _wrap(out, mesh, out_pl, tuple(i.shape) + tuple(x.shape[1:]))


def _gather(cost, func, args, kwargs):
    """``torch.gather`` along ``dim`` on the shards: an operand sharded
    along another dim gives the other (its replicated partner) the
    matching slice; values sharded along ``dim`` with a replicated index
    are looked up on each shard and all-reduced, as ``_embedding`` does.
    DTensor's rule for anything else."""
    from torch.distributed.tensor import Replicate
    dt = _dtensor()
    x, dim, idx = args[0], args[1], args[2]
    mesh = next(a for a in (x, idx) if isinstance(a, dt)).device_mesh
    if not isinstance(x, dt):
        x = _wrap(x.to("meta"), mesh, [Replicate()] * mesh.ndim)
    if not isinstance(idx, dt):
        idx = _wrap(idx.to("meta"), mesh, [Replicate()] * mesh.ndim)
    x = cost.reduce_partial(x)
    dim %= x.dim()
    want_x, want_i, reduce = [], [], []
    for d, (xp, ip) in enumerate(zip(x.placements, idx.placements)):
        if ip.is_partial() or ip.is_shard() and (
                ip.dim == dim or xp.is_shard() and xp != ip):
            return _to_dtensor(cost, func, (x,) + tuple(args[1:]), kwargs)
        if xp.is_shard(dim):
            want_x.append(xp)
            want_i.append(Replicate())
            reduce.append(d)
        else:
            p = xp if xp.is_shard() else ip
            want_x.append(p)
            want_i.append(p)
    out = cost.run(func, (cost.localize(x, want_x, mesh), dim,
                          cost.localize(idx, want_i, mesh)) + tuple(args[3:]),
                   kwargs)
    for _ in range(_axes_over(mesh, reduce)):
        cost.add_collective("all-reduce", out.numel() * out.element_size())
    return _wrap(out, mesh, [Replicate() if d in reduce else p
                             for d, p in enumerate(want_i)], idx.shape)


def _index_tensors(func, args):
    """(indexed dims of ``self`` or None for any, index tensors, the
    other tensors)."""
    name = func._overloadpacket.__name__
    if name.startswith(("index_add", "index_copy", "scatter")):
        dim = args[1] % args[0].dim()
        if name.startswith("scatter"):   # index is per element of src
            return {dim}, [], [t for t in args[2:4]
                               if isinstance(t, torch.Tensor)]
        return {dim}, [args[2]], [args[3]]
    if name.startswith(("index_put", "_index_put_impl")):
        idx = list(args[1])
        first = next(k for k, t in enumerate(idx) if t is not None)
        return set(range(first, args[0].dim())), \
            [t for t in idx if t is not None], [args[2]]
    return None, [], []


def _scatter(cost, func, args, kwargs):
    from torch.distributed.tensor import Replicate
    dt = _dtensor()
    mesh = next(a for a in tree_flatten((args, kwargs))[0]
                if isinstance(a, dt)).device_mesh
    indexed, index, others = _index_tensors(func, args)
    self_ = args[0]
    if not isinstance(self_, dt):   # a plain target (zeros a backward
        # formula makes by a factory) is replicated
        self_ = _wrap(self_.to("meta"), mesh, [Replicate()] * mesh.ndim)
        args = (self_,) + tuple(args[1:])
    pl = _placements_of(self_, mesh.ndim)
    rep = [Replicate()] * mesh.ndim
    local = indexed is not None and not any(p.is_partial() for p in pl)
    if local:
        # a replicated target takes the shards of updates sharded along a
        # dim the op does not index (the gradient of a gather sharded by
        # batch): each device scatters into its own slice of it
        for m, p in enumerate(pl):
            if p.is_shard() or mesh.size(m) == 1:
                continue
            q = next((t.placements[m] for t in others if isinstance(t, dt)
                      and t.placements[m].is_shard()
                      and t.placements[m].dim not in indexed
                      and t.placements[m].dim < self_.dim()), None)
            if q is not None:
                pl[m] = q
    # the updates follow the target where it is sharded along a dim the op
    # does not index; elsewhere each shard takes all of them
    want = [p if p.is_shard() and p.dim not in indexed else Replicate()
            for p in pl] if local else rep
    slots = {id(t): rep for t in index}
    slots.update({id(t): want for t in others})

    def unwrap(x):
        if not isinstance(x, dt):  # a host index: every shard holds it
            return x.to("meta")
        if local and x is self_:
            return x._local_tensor if pl == list(x.placements) else \
                cost.localize(x, pl, mesh)  # (a slice: no collective)
        return cost.localize(x, slots.get(id(x), rep), mesh)
    out = cost.run(func, tree_map_only(torch.Tensor, unwrap, args),
                   tree_map_only(torch.Tensor, unwrap, kwargs))
    if func._schema.is_mutable:
        return self_
    return _wrap(out, mesh, pl if local else rep,
                 self_.shape if local else None)


def _pad(cost, func, args, kwargs):
    from torch.distributed.tensor import Replicate
    x, pad = args[0], args[1]
    mesh = x.device_mesh
    padded = {x.dim() - 1 - k // 2 for k, n in enumerate(pad) if n}
    want = [Replicate() if p.is_partial() or (p.is_shard() and p.dim in
                                               padded) else p
            for p in x.placements]
    out = cost.run(func, (cost.localize(x, want, mesh),) + tuple(args[1:]),
                   kwargs)
    return _wrap(out, mesh, want, _global_out(func, args, kwargs).shape)


def _diagonal_backward(cost, func, args, kwargs):
    from torch.distributed.tensor import Shard
    grad, sizes, offset, d1, d2 = args[:5]
    mesh = grad.device_mesh
    sizes = list(sizes)
    d1, d2 = d1 % len(sizes), d2 % len(sizes)
    # grad's leading dims are the input's other dims in order, its last the
    # diagonal (sharded like dim1 of the input)
    dims = [k for k in range(len(sizes)) if k not in (d1, d2)] + [d1]
    pl = [Shard(dims[p.dim]) if p.is_shard() else p for p in grad.placements]
    out = cost.run(func, (grad._local_tensor, _local_shape(sizes, pl, mesh),
                          offset, d1, d2) + tuple(args[5:]), kwargs)
    return _wrap(out, mesh, pl, sizes)


def _sort(cost, func, args, kwargs):
    """A sort (``argsort``, the stable top-k) along a sharded dim: that
    dim gathered, as XLA sorts, the other dims' shards kept; values and
    indices placed alike."""
    from torch.distributed.tensor import Replicate
    x = cost.reduce_partial(args[0])
    dim = kwargs.get("dim", args[1] if len(args) > 1 else -1) % x.dim()
    mesh = x.device_mesh
    want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
    out = cost.run(func, (cost.localize(x, want, mesh),) + tuple(args[1:]),
                   kwargs)
    return tuple(_wrap(o, mesh, want, x.shape) for o in out)


def _diagonal(cost, func, args, kwargs):
    """A diagonal of a tensor sharded along one of its two dims (the
    in-batch positives of row-sharded (B, B) log-probabilities): each
    device takes the diagonal of its own rows (this rank's block starts
    at the diagonal), sharded along the diagonal; the other dims keep
    their shards. DTensor's rule where both dims are sharded."""
    from torch.distributed.tensor import Shard
    x = cost.reduce_partial(args[0])
    offset = args[1] if len(args) > 1 else kwargs.get("offset", 0)
    d1 = (args[2] if len(args) > 2 else kwargs.get("dim1", 0)) % x.dim()
    d2 = (args[3] if len(args) > 3 else kwargs.get("dim2", 1)) % x.dim()
    mesh = x.device_mesh
    if offset or (any(p.is_shard(d1) for p in x.placements) and
                  any(p.is_shard(d2) for p in x.placements)):
        return _to_dtensor(cost, func, (x,) + tuple(args[1:]), kwargs)
    others = [k for k in range(x.dim()) if k not in (d1, d2)]
    pl = [Shard(len(others)) if p.is_shard(d1) or p.is_shard(d2) else
          Shard(others.index(p.dim)) if p.is_shard() else p
          for p in x.placements]
    out = cost.run(func, (x._local_tensor,) + tuple(args[1:]), kwargs)
    return _wrap(out, mesh, pl, _global_out(func, (x,) + tuple(args[1:]),
                                            kwargs).shape)


def _slice_shares(x_pl, mesh, dim, size, start, length):
    """(n devices along the mesh dims sharding ``dim``, whether some
    device's even share of ``[start, start + length)`` lies outside its
    own block of the ``size`` rows), or None where the shares are not
    even."""
    mdims = [d for d, p in enumerate(x_pl) if p.is_shard(dim)
             and mesh.size(d) > 1]
    n = _numel([mesh.size(d) for d in mdims])
    if not mdims or size % n or length % n:
        return None
    c, co = size // n, length // n
    moved = any(not (r * c <= start + r * co and
                     start + (r + 1) * co <= (r + 1) * c) for r in range(n))
    return n, moved


def _slice(cost, func, args, kwargs):
    """A slice along a sharded dim (GIN's seeds, ``h[:n_seeds]``): each
    device keeps its even share of the range, sharded as the input; a
    share that lies on another device's rows arrives by a
    collective-permute of the output shard (XLA's), counted once a
    device. A range that does not split evenly, or a step, gathers the
    dim first. Slices along unsharded dims are DTensor's (no
    collective)."""
    from torch.distributed.tensor import Replicate
    x = args[0]
    dim = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % x.dim()
    size = x.shape[dim]
    start, end, step = (list(args[2:5]) + [None] * 3)[:3]
    start = kwargs.get("start", start)
    end = kwargs.get("end", end)
    step = kwargs.get("step", step) or 1
    start, end, _ = slice(start, end, step).indices(size)
    length = max(0, -(-(end - start) // step))
    mesh = x.device_mesh
    if not any(p.is_shard(dim) and mesh.size(d) > 1
               for d, p in enumerate(x.placements)):
        return _to_dtensor(cost, func, args, kwargs)
    shares = None if step != 1 else _slice_shares(
        x.placements, mesh, dim, size, start, length)
    shape = list(x.shape)
    shape[dim] = length
    if shares is None:
        want = [Replicate() if p.is_shard(dim) else p for p in x.placements]
        out = cost.run(func, (cost.localize(x, want, mesh), dim, start, end,
                              step), {})
        return _wrap(out, mesh, want, shape)
    n, moved = shares
    out = cost.run(func, (x._local_tensor, dim, 0, length // n, 1), {})
    if moved:
        cost.add_collective("collective-permute",
                            out.numel() * out.element_size())
    return _wrap(out, mesh, list(x.placements), shape)


def _slice_backward(cost, func, args, kwargs):
    """A slice's backward (``_slice``'s placements): each device puts its
    share of the gradient into its own rows, the shares that belong to
    another device's rows moved by a collective-permute; unsharded
    along the sliced dim, or uneven, the gradient is gathered there."""
    from torch.distributed.tensor import Replicate
    grad, sizes, dim, start, end, step = args[:6]
    dim %= grad.dim()
    sizes = list(sizes)
    mesh = grad.device_mesh
    shares = None if step != 1 else _slice_shares(
        grad.placements, mesh, dim, sizes[dim], start, grad.shape[dim])
    if shares is None:
        want = [Replicate() if p.is_shard(dim) else p
                for p in grad.placements]
        g = cost.localize(grad, want, mesh)
    else:
        want = list(grad.placements)
        g = grad._local_tensor
        if shares[1]:
            cost.add_collective("collective-permute",
                                g.numel() * g.element_size())
        start, end = 0, g.shape[dim]
    out = cost.run(func, (g, _local_shape(sizes, want, mesh), dim, start, end,
                          step), {})
    return _wrap(out, mesh, want, sizes)


def _matmul(cost, func, args, kwargs):
    """``mm`` and ``bmm`` on the shards, placed per mesh dim as XLA's
    partitioner places a dot: operands sharded alike along the batch dim
    give a batch-sharded product, along the contraction a partial sum;
    one operand sharded along its free dim (or the batch, or the
    contraction) and the other replicated, the replicated one takes the
    matching local slice, but an operand sharded FSDP-style (along the
    contraction over a data axis) is gathered instead where that moves
    fewer bytes than the partial product's all-reduce (twice its
    bytes). Where the two are sharded along different
    roles on one mesh dim, one is gathered there: the one sharded along
    the contraction when the other is sharded along a free or batch dim
    (a weight sharded FSDP-style over the tokens' axis), else the smaller
    (decode's query heads against the cache's positions). Partial
    operands are reduced first."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dt = _dtensor()
    mesh = next(x for x in args[:2] if isinstance(x, dt)).device_mesh
    keys = [cost.weight_key(x) for x in args[:2]]
    a, b = (cost.reduce_partial(x) if isinstance(x, dt) else
            _wrap(x.to("meta"), mesh, [Replicate()] * mesh.ndim)
            for x in args[:2])
    nd = a.dim()
    a, b, split = _presplit(cost, args[:2], a, b)
    roles_a = {nd - 2: "m", nd - 1: "k"}
    roles_b = {nd - 2: "k", nd - 1: "n"}
    if nd == 3:
        roles_a[0] = roles_b[0] = "b"
    la, lb = a._local_tensor.shape, b._local_tensor.shape
    size_a = a._local_tensor.numel() * a.element_size()
    size_b = b._local_tensor.numel() * b.element_size()
    # the local product's bytes, its operands sliced to each other's shards
    out_b = la[-2] * lb[-1] * (min(la[0], lb[0]) if nd == 3 else 1) * \
        a.element_size()
    want_a, want_b, out_pl = [], [], []
    for d, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        ra = roles_a[pa.dim] if pa.is_shard() and mesh.size(d) > 1 else None
        rb = roles_b[pb.dim] if pb.is_shard() and mesh.size(d) > 1 else None
        if ra and rb and ra != rb:
            if "k" in (ra, rb):         # keep the free dim's shards
                ra, rb = (None, rb) if ra == "k" else (ra, None)
            elif size_a <= size_b:      # gather the smaller operand
                ra = None
            else:
                rb = None
        elif "k" in (ra, rb) and None in (ra, rb) and \
                axis_of(mesh.mesh_dim_names[d]) in DP and (
                    size_a if ra else size_b) * mesh.size(d) < 2 * out_b:
            # sharded FSDP-style (the contraction over a data axis)
            # against a replicated operand (MoE's expert buffer): gathered
            # where that moves fewer bytes than the partial product's
            # all-reduce
            ra = rb = None
        role = ra or rb
        if role is None:
            want_a.append(Replicate())
            want_b.append(Replicate())
            out_pl.append(Replicate())
            continue
        dim_a = {"b": 0, "m": nd - 2, "k": nd - 1}.get(role)
        dim_b = {"b": 0, "k": nd - 2, "n": nd - 1}.get(role)
        want_a.append(Shard(dim_a) if dim_a is not None else Replicate())
        want_b.append(Shard(dim_b) if dim_b is not None else Replicate())
        out_pl.append(Partial() if role == "k" else
                      Shard({"b": 0, "m": nd - 2, "n": nd - 1}[role]))
    al = cost.localize(a, want_a, mesh, keys[0])
    bl = cost.localize(b, want_b, mesh, keys[1])
    flops, hbm = cost.flops, cost.bytes
    out = cost.run(func, (al, bl), kwargs)
    flops, hbm = cost.flops - flops, cost.bytes - hbm
    # a free dim sharded by one operand only: what gathering that operand
    # would change instead, the other sliced to match (a "gather") or, where
    # the other was gathered, kept sharded (a "swap"), for ``_carry``
    alts = {}
    shape = tuple(a.shape[:-1]) + (b.shape[-1],)
    for d, (pa, pb) in enumerate(zip(a.placements, b.placements)):
        q, n = out_pl[d], mesh.size(d)
        if q.is_replicate() and n > 1:
            alts[d] = ("slice", 0, shape, flops, (
                al.numel() * al.element_size(), bl.numel() * bl.element_size(),
                out.numel() * out.element_size()), None)
        if not q.is_shard() or q.dim == 0 or n == 1:
            continue
        kept, other, key = (al, b, keys[0]) if want_a[d].is_shard() else \
            (bl, a, keys[1])
        ob = kept.numel() * kept.element_size()
        if pa.is_shard() != pb.is_shard():
            alts[d] = ("gather", 0, ob, flops,
                       ob + out.numel() * out.element_size(), key)
        elif pa.is_shard() and pb.is_shard():
            ol = other._local_tensor
            counted = ol.numel() * ol.element_size() * n
            alts[d] = ("swap", counted, ob, 0.0, (ob - counted / n), None)
    if alts:
        cost.products[_storage(out)] = (out, alts)
    if split:
        # the split's partial sum all-reduced at once, as XLA reduces it
        # (``all-reduce.32`` of the two-tower's ``dot.14``)
        for _ in range(_axes_over(mesh, split)):
            cost.add_collective("all-reduce", out.numel() * out.element_size())
        out_pl = [Replicate() if d in split else p
                  for d, p in enumerate(out_pl)]
    return _wrap(out, mesh, out_pl, shape)


def _presplit(cost, args, a, b):
    """``a`` and ``b`` (a product's operands) where one is a hint's
    gathered output (``ShardedCost.gathered``) whose shards before the
    gather split the contraction on a mesh dim where the other operand
    is replicated: that one at those shards (they are still at hand), so
    the product splits along them into a partial sum, as XLA splits the
    two-tower's ``g @ v`` over the items' model shards. Operands
    replicated all along are left whole. Returns both and the mesh dims
    split."""
    nd = a.dim()
    ops, split = [a, b], []
    for i, (arg, op) in enumerate(zip(args, ops)):
        rec = cost.gathered.get(_key(arg._local_tensor)) \
            if isinstance(arg, _dtensor()) else None
        if rec is None:
            continue
        k = nd - 1 if i == 0 else nd - 2      # the operand's contraction dim
        other = ops[1 - i]
        pl = list(op.placements)
        for d, pre in enumerate(rec[1]):
            if not pre.is_shard() or not pl[d].is_replicate() or \
                    not other.placements[d].is_replicate():
                continue
            if _same_dim(op.shape, rec[2], pre.dim) == k:
                pl[d] = type(pre)(k)
                split.append(d)
        if pl != list(op.placements):
            mesh = op.device_mesh
            ops[i] = _wrap(torch.empty(_local_shape(op.shape, pl, mesh),
                                       dtype=op.dtype, device="meta"),
                           mesh, pl, op.shape)
    return ops + [split]


def _to_dtensor(cost, func, args, kwargs):
    """Leave ``func`` to DTensor, on ``args`` whose partial sums a rule
    has already reduced (its collectives are DTensor's choice)."""
    cost._op = cost._declined = func
    with cost:
        return func(*args, **kwargs)


def _elementwise(cost, func, args, kwargs):
    """A pointwise op on operands placed alike, run on the shards (torch
    2.11 has no DTensor rule for leaky_relu: it decomposes the op and
    runs the parts at global shapes)."""
    dt = _dtensor()
    args = tuple(cost.reduce_partial(a) if isinstance(a, dt) else a
                 for a in args)
    dts = [a for a in args if isinstance(a, dt)]
    if any(a.placements != dts[0].placements for a in dts):
        return _to_dtensor(cost, func, args, kwargs)
    out = cost.run(func, tuple(a._local_tensor if isinstance(a, dt) else a
                               for a in args), kwargs)
    return _wrap(out, dts[0].device_mesh, list(dts[0].placements),
                 _global_out(func, args, kwargs).shape)


def _softmax(cost, func, args, kwargs):
    """A softmax (or its backward) along a dim its operands are sharded
    on, placed as XLA places it: each device normalizes its own slice,
    the max and the sum along the dim all-reduced (the backward's one
    sum), the output sharded as the input (decode's scores over a
    position-sharded cache)."""
    dt = _dtensor()
    backward = func._overloadpacket is torch.ops.aten._softmax_backward_data
    xs = [cost.reduce_partial(a) for a in args[:2 if backward else 1]]
    dim = args[len(xs)] % xs[0].dim()
    mesh, pl = xs[0].device_mesh, list(xs[0].placements)
    if any(x.placements != xs[0].placements for x in xs) or not any(
            p.is_shard(dim) and mesh.size(d) > 1 for d, p in enumerate(pl)):
        return _to_dtensor(cost, func, tuple(xs) + tuple(args[len(xs):]),
                           kwargs)
    out = cost.run(func, tuple(x._local_tensor for x in xs)
                   + tuple(args[len(xs):]), kwargs)
    reduced = out.numel() // out.shape[dim] * out.element_size()
    for _ in range(1 if backward else 2):
        cost.add_collective("all-reduce", reduced)
    return _wrap(out, mesh, pl, xs[0].shape)


def _view_groups(ishape, oshape):
    """The (input dims, output dims) groups a view maps onto each other
    (size-1 dims alone)."""
    groups, i, o = [], 0, 0
    while i < len(ishape) or o < len(oshape):
        if i < len(ishape) and ishape[i] == 1:
            groups.append(([i], []))
            i += 1
            continue
        if o < len(oshape) and oshape[o] == 1:
            groups.append(([], [o]))
            o += 1
            continue
        ins, outs, pi, po = [i], [o], ishape[i], oshape[o]
        i, o = i + 1, o + 1
        while pi != po:
            if pi < po:
                ins.append(i)
                pi *= ishape[i]
                i += 1
            else:
                outs.append(o)
                po *= oshape[o]
                o += 1
        groups.append((ins, outs))
    return groups


def _view_placements(x, shape, merges: dict):
    """A view's output placements, or None to leave it to DTensor. A
    merge keeps every shard on the merged dim (the (batch, heads) batch
    of an einsum's product: data and model both) and records which input
    dim each mesh dim sharded in ``merges``; a split that undoes a
    recorded merge (same size, placements and factors: the product's
    output) gives each mesh dim back its dim; any other split gives the
    input dim's mesh dims to the first output dims they divide."""
    from torch.distributed.tensor import Shard
    mesh, pl = x.device_mesh, list(x.placements)
    if any(p.is_shard() and p.dim >= x.dim() for p in pl):
        return None
    ishape = list(x.shape)
    groups = _view_groups(ishape, shape)
    rem = list(shape)
    out = list(pl)
    for ins, outs in groups:
        mdims = [d for d, p in enumerate(pl) if p.is_shard() and p.dim in ins]
        if not mdims:
            continue
        if len(outs) == 1:
            # shards along later input dims must come from later mesh dims
            order = [pl[d].dim for d in mdims]
            if order != sorted(order):
                return None
            for d in mdims:   # (a dim kept whole may be sharded unevenly)
                if len(ins) > 1 and rem[outs[0]] % mesh.size(d):
                    return None
                rem[outs[0]] = -(-rem[outs[0]] // mesh.size(d))
                out[d] = Shard(outs[0])
            if len(ins) > 1:
                merges[(shape[outs[0]], tuple(mdims))] = (
                    tuple(ishape[i] for i in ins),
                    {d: ins.index(pl[d].dim) for d in mdims})
        elif len(ins) == 1:
            rec = merges.get((ishape[ins[0]], tuple(mdims)))
            undo = rec is not None and rec[0] == tuple(shape[o] for o in outs)
            k = 0
            for d in mdims:
                if undo:
                    k = rec[1][d]
                # (undoing a merge, the dim may be sharded unevenly)
                while not undo and k < len(outs) and \
                        rem[outs[k]] % mesh.size(d):
                    k += 1
                if k == len(outs):
                    return None
                rem[outs[k]] = -(-rem[outs[k]] // mesh.size(d))
                out[d] = Shard(outs[k])
        else:
            return None
    return out


def _view(cost, func, args, kwargs):
    """A view on the shards (see ``_view_placements``); DTensor's own
    rule where that gives none."""
    x, shape = args[0], list(args[1])
    if -1 in shape:
        known = _numel([s for s in shape if s != -1])
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    pl = _view_placements(x, shape, cost.merges)
    if pl is None and _uneven([x]):
        x = cost.gather_uneven(x)   # XLA gathers a padded dim it reshapes
        pl = _view_placements(x, shape, cost.merges)
        if pl is None:
            return _to_dtensor(cost, func, (x,) + tuple(args[1:]), kwargs)
    if pl is None:
        cost._op = func
        return NotImplemented
    mesh = x.device_mesh
    local = _local_shape(shape, pl, mesh)
    try:
        out = cost.run(func, (x._local_tensor, local) + tuple(args[2:]),
                       kwargs)
    except RuntimeError:
        # the shard's strides do not allow the view (a wrapped shard is
        # contiguous where the global tensor was not): a view moves no
        # bytes, so a fresh shard of the view's shape stands for it
        out = x._local_tensor.new_empty(local)
    return _wrap(out, mesh, pl, shape)


def _rules():
    aten = torch.ops.aten
    rules = {aten.embedding: _embedding,
             aten.embedding_dense_backward: _embedding_backward,
             aten.constant_pad_nd: _pad,
             aten.diagonal: _diagonal,
             aten.diagonal_backward: _diagonal_backward,
             aten.sort: _sort, aten.index: _index, aten.gather: _gather,
             aten.slice: _slice, aten.slice_backward: _slice_backward,
             aten.mm: _matmul, aten.bmm: _matmul,
             aten.view: _view, aten._unsafe_view: _view,
             aten.leaky_relu: _elementwise,
             aten.leaky_relu_backward: _elementwise,
             aten._softmax: _softmax, aten._softmax_backward_data: _softmax}
    for op in (aten.index_add, aten.index_add_, aten.index_copy,
               aten.index_copy_, aten.scatter, aten.scatter_,
               aten.scatter_add, aten.scatter_add_, aten.index_put,
               aten.index_put_,
               aten._index_put_impl_, aten.searchsorted, aten.bincount):
        rules[op] = _scatter
    return rules


_RULES = _rules()


def model_axis_factors(cfg, mesh: Mesh):
    """How the dry-run factors the "model" axis for ``cfg`` (None: not at
    all). Grouped-query attention views the model-sharded heads as (KV
    groups, queries a group); where the axis does not divide the groups
    (8 of them over model=16), each device holds part of one group, which
    one mesh dim cannot place. XLA shards both dims of the view over the
    one axis; the dry-run does the same by splitting the axis into
    consecutive dims (gcd(KV heads, model), the rest) that shard the
    groups and the queries within one."""
    import math
    m = dict(zip(mesh.axes, mesh.shape)).get("model", 1)
    h, hkv = getattr(cfg, "n_heads", 0), getattr(cfg, "n_kv_heads", 0)
    if m == 1 or not hkv or getattr(cfg, "attn_type", "mla") == "mla" \
            or h % m or hkv % m == 0:
        return None
    a = math.gcd(hkv, m)
    return (a, m // a) if (h // hkv) % (m // a) == 0 else None


@contextlib.contextmanager
def fake_device_mesh(mesh: Mesh, factors=None):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names on a ``fake``
    process group of ``mesh.size`` ranks (this process is rank 0),
    destroyed on exit, with DTensor's strict views relaxed
    (``_relaxed_views``). ``factors`` (``model_axis_factors``) splits the
    "model" axis into dims "model", "model.1"."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    shape, names = [], []
    for axis, n in zip(mesh.axes, mesh.shape):
        if axis == "model" and factors:
            shape += list(factors)
            names += ["model", "model.1"]
        else:
            shape.append(n)
            names.append(axis)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        with _relaxed_views():
            yield init_device_mesh("cpu", tuple(shape),
                                   mesh_dim_names=tuple(names))
    finally:
        dist.destroy_process_group()


def _place(x, spec, dmesh, mesh):
    """A ``meta`` tensor as a DTensor of ``meta`` shards placed by
    ``spec``; anything else (a host scalar) as it is."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(x, torch.Tensor) or x.device.type != "meta":
        return x
    spec = _divisible_spec(filter_spec(spec, mesh), tuple(x.shape), mesh)
    pl = placements(spec, dmesh)
    local = list(x.shape)
    for size, p in zip(dmesh.shape, pl):
        if isinstance(p, Shard):
            local[p.dim] //= size
    t = DTensor.from_local(torch.empty(local, dtype=x.dtype, device="meta"),
                           dmesh, pl, run_check=False, shape=x.shape,
                           stride=x.stride())
    return nn.Parameter(t, requires_grad=x.requires_grad) \
        if isinstance(x, nn.Parameter) else t


def _place_module(mod, spec, dmesh, mesh):
    """Replace every parameter of a ``ParamTree`` module (in place) by
    its placed DTensor; ``spec`` is the module's spec tree."""
    for name, child in mod.named_children():
        if isinstance(child, nn.ParameterList):
            for i, p in enumerate(child):
                child[i] = _place(p, spec[name][i], dmesh, mesh)
        else:
            _place_module(child, spec[name], dmesh, mesh)
    for name, p in list(mod.named_parameters(recurse=False)):
        setattr(mod, name, _place(p, spec[name], dmesh, mesh))
    return mod


def _place_arg(arg, spec, dmesh, mesh):
    if isinstance(arg, nn.Module):
        return _place_module(arg, spec, dmesh, mesh)
    return tree_map(lambda x, s: _place(x, s, dmesh, mesh), arg, spec)


def _local_bytes(tree) -> int:
    n = 0
    for x in leaves(tree.to_tree() if isinstance(tree, nn.Module) else tree):
        if isinstance(x, torch.Tensor):
            x = x.to_local() if hasattr(x, "to_local") else x
            n += x.numel() * x.element_size()
    return n


def _outputs(out):
    """A step's outputs as a tree of tensors (modules as their trees)."""
    if isinstance(out, nn.Module):
        return out.to_tree()
    if isinstance(out, (tuple, list)):
        return [_outputs(o) for o in out]
    if isinstance(out, dict):
        return {k: _outputs(v) for k, v in out.items()}
    return out if isinstance(out, torch.Tensor) else None


def model_cell(step, mesh: Mesh, hw: str, strict: bool = False) -> dict:
    """Run ``step`` on DTensors over ``mesh`` (a fake group) and price
    rank 0's counts. ``dtensor_choices`` lists the collectives DTensor
    chose by itself (its choices differ between torch versions); under
    ``strict`` the first one raises."""
    from torch.distributed.tensor.experimental import implicit_replication
    factors = model_axis_factors(getattr(step.args[0], "cfg", None), mesh)
    with fake_device_mesh(mesh, factors) as dmesh:
        args = tuple(_place_arg(a, s, dmesh, mesh)
                     for a, s in zip(step.args, step.in_specs))
        cost = ShardedCost(strict)
        cost.hold_weights(
            x for a in args for x in leaves(
                a.to_tree() if isinstance(a, nn.Module) else a)
            if isinstance(x, _dtensor()) and x.requires_grad)
        with implicit_replication(), cost:
            out = step.fn(*args)
        analysis = hlo_analysis.analyze(
            cost, step.meta.get("model_flops_per_step", 0), mesh.size,
            argument_bytes=sum(_local_bytes(a) for a in args),
            output_bytes=_local_bytes(_outputs(out)), hw=hw)
    analysis["dtensor_choices"] = {f"{op} {kind}": b for (op, kind), b
                                   in sorted(cost.implicit.items())}
    return analysis


# -------------------------------------------------------------- ranking cells
def _seg_sum(vals, ids, n: int):
    """``jax.ops.segment_sum``: rows of ``vals`` added at ``ids``; an id
    outside [0, n) adds nothing."""
    ids = ids.long()
    keep = ((ids >= 0) & (ids < n)).to(vals.dtype)
    if vals.dim() > 1:
        keep = keep[:, None]
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, ids.clamp(0, n - 1), vals * keep)


def _weighted(x, w):
    return x * (w[:, None] if x.dim() == 2 else w)


def make_dryrun_rank_sweep(mesh: Mesh, n: int, axes, mode: str = "baseline",
                           n_hub: int = None, shard_scope=None):
    """The distributed power sweep for the dry-run: edge shards arrive as
    arguments (per-shard lists of rows, shard s's row at s), ca/ch folded
    into per-edge weights host-side. ``shard_scope(s)`` is entered around
    shard s's share of the body (the dry-run counts shard 0's).

    Modes: baseline (replicated vector, 2 psums/sweep) | dual_blocked
    (block-owned scatters, 2 all-gathers/sweep) | +bf16 (vector/weight
    storage bf16, fp32 accumulation for norms/residuals) | +compact (hub
    vectors in the non-dangling space)."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    n_shards = _axis_size(tuple(axes), sizes)
    if n_shards != mesh.size:
        raise ValueError(f"the sweep shards over every axis; {axes} hold "
                         f"{n_shards} of {mesh.size}")
    scope = shard_scope or (lambda s: contextlib.nullcontext())
    shards = range(n_shards)

    if "dual_blocked" in mode:
        n_h = n_hub if ("compact" in mode and n_hub) else n
        nb_a = -(-n // n_shards)
        nb_h = -(-n_h // n_shards)

        def sweep(h_blk, asrc, adst, aw, am, hsrc, hdst, hw, hm):
            dt = h_blk[0].dtype
            # gathered in the storage dtype, widened after the collective
            h_full = all_gather(mesh, list(h_blk))            # (n_h,)
            a_blk = []
            for s in shards:
                with scope(s):
                    wm = (aw[s] * am[s]).float()
                    hw_g = _weighted(h_full[s].float().index_select(
                        0, asrc[s].long()), wm)
                    a_blk.append(_seg_sum(hw_g, adst[s].long() - s * nb_a,
                                          nb_a).to(dt))
            a_full = all_gather(mesh, a_blk)                  # (n,)
            h_new, parts = [], []
            for s in shards:
                with scope(s):
                    wm = (hw[s] * hm[s]).float()
                    aw_g = _weighted(a_full[s].float().index_select(
                        0, hsrc[s].long()), wm)
                    h_new.append(_seg_sum(aw_g, hdst[s].long() - s * nb_h,
                                          nb_h))
                    parts.append(h_new[s].abs().sum())
            tot = psum(mesh, parts)
            out = []
            for s in shards:
                with scope(s):
                    out.append((h_new[s] / (tot[s] + 1e-30)).to(dt))
            return out, a_blk

        return sweep

    def sweep(h, src, dst, w, mask):
        dt = h[0].dtype
        parts = []
        for s in shards:
            with scope(s):
                wm = w[s] * mask[s]
                parts.append(_seg_sum(_weighted(
                    h[s].index_select(0, src[s].long()), wm), dst[s], n))
        a = psum(mesh, parts)
        parts = []
        for s in shards:
            with scope(s):
                wm = w[s] * mask[s]
                parts.append(_seg_sum(_weighted(
                    a[s].index_select(0, dst[s].long()), wm), src[s], n))
        h_new = psum(mesh, parts)
        out = []
        for s in shards:
            with scope(s):
                hf = h_new[s].float()
                tot = hf.abs().sum(dim=0, keepdim=hf.dim() > 1)
                out.append((hf / (tot + 1e-30)).to(dt))
        return out, a

    return sweep


def _shard_arg(mesh: Mesh, x, spec):
    """A ranking argument on the mesh: sharded over every axis (the edge
    shards and blocked vectors: row s on shard s) or replicated."""
    return mesh.shard_rows(x) if len(spec) and spec[0] is not None \
        else mesh.replicate(x)


def rank_cell(spec, shape_name: str, mesh: Mesh, mode: str, hw: str) -> dict:
    step = build_step(spec, shape_name, n_devices=mesh.size, mode=mode)
    shp = spec.shapes[shape_name]
    n_hub = int(shp["n_nodes"] * (1 - shp.get("dangling_frac", 0.0)))
    cost = StepCost()
    fn = make_dryrun_rank_sweep(mesh, shp["n_nodes"], axes=mesh.axes,
                                mode=mode, n_hub=n_hub,
                                shard_scope=lambda s: cost.only(s == 0))
    args = [_shard_arg(mesh, a, filter_spec(s, mesh))
            for a, s in zip(step.args, step.in_specs)]
    mesh.reset_counters()
    with cost, cost.only(False):
        fn(*args)
    out_b = {k: float(v) for k, v in mesh.collective_bytes.items()}
    moved = {k: v * _MOVED.get(k, 1.0) for k, v in out_b.items()}
    coll = {"total_bytes": sum(moved.values()), "by_kind": moved,
            "output_bytes_by_kind": out_b,
            "n_collective_ops": mesh.collective_ops}
    arg_b = sum(a[0].numel() * a[0].element_size() for a in args)
    return step, hlo_analysis.analyze(
        cost, step.meta.get("model_flops_per_step", 0), mesh.size,
        collectives=coll, argument_bytes=arg_b, hw=hw)


# ---------------------------------------------------------------------- cells
def make_mesh(mesh_name: str, device="cuda") -> Mesh:
    if mesh_name == "host":
        return make_host_mesh(device=device)
    return make_production_mesh(multi_pod=mesh_name == "pod2")


def run_cell(arch: str, shape_name: str, mesh_name: str, out_dir: str,
             mode: str = "baseline", force: bool = False,
             hw: str = hlo_analysis.DEFAULT_HW, device="cuda",
             strict: bool = False) -> dict:
    """One cell: its JSON under ``out_dir`` (an ``ok`` or ``skipped``
    result there is reused unless ``force``; an error is retried).
    ``strict``: a model cell where DTensor would choose a collective
    itself is an error (``model_cell``)."""
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_name}__{mode}"
    out_path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(out_path) and not force:
        with open(out_path) as f:
            cached = json.load(f)
        if cached.get("status") in ("ok", "skipped"):
            return cached  # errors are always retried

    spec = get_spec(arch)
    skip = spec.skip_shapes.get(shape_name)
    if skip:
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "mode": mode, "status": "skipped", "reason": skip}
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
        return result

    t0 = time.time()
    try:
        mesh = make_mesh(mesh_name, device)
        if spec.family == "ranking":
            step, analysis = rank_cell(spec, shape_name, mesh, mode, hw)
        else:
            step = build_step(spec, shape_name, mode=mode)
            analysis = model_cell(step, mesh, hw, strict)
        result = {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "mode": mode, "status": "ok",
            "compile_s": round(time.time() - t0, 1),
            "hw": hlo_analysis.hardware(hw).describe(mesh.size),
            "meta": {k: v for k, v in step.meta.items()
                     if isinstance(v, (int, float, str))},
            **analysis,
        }
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                  "mode": mode, "status": "error", "error": repr(e),
                  "traceback": traceback.format_exc()[-2000:],
                  "compile_s": round(time.time() - t0, 1)}
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="pod1", choices=["pod1", "pod2", "host"],
                    help="host: the visible devices of --device (one card)")
    ap.add_argument("--mode", default="baseline")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-ranking", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--hw", default=hlo_analysis.DEFAULT_HW,
                    choices=sorted(hlo_analysis.HARDWARE))
    ap.add_argument("--device", default="cuda",
                    help="the device type of --mesh host")
    ap.add_argument("--strict", action="store_true",
                    help="a model cell whose collectives DTensor would "
                    "choose itself is an error")
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for arch_id, spec in REGISTRY.items():
            if spec.family == "ranking" and not args.include_ranking:
                continue
            for shape_name in spec.shapes:
                cells.append((arch_id, shape_name))
    else:
        if args.arch is None:
            ap.error("give --arch or --all")
        spec = get_spec(args.arch)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        cells = [(args.arch, s) for s in shapes]

    for arch_id, shape_name in cells:
        r = run_cell(arch_id, shape_name, args.mesh, args.out, args.mode,
                     args.force, args.hw, args.device, args.strict)
        status = r["status"]
        extra = ""
        if status == "ok":
            rl = r["roofline"]
            extra = (f" bottleneck={rl['bottleneck']}"
                     f" frac={rl['roofline_fraction']:.3f}"
                     f" compile={r['compile_s']}s"
                     f" dtensor_choices={len(r.get('dtensor_choices', {}))}")
        elif status == "error":
            extra = " " + r["error"][:120]
        print(f"[{status:7s}] {arch_id:22s} {shape_name:14s} {args.mesh}{extra}",
              flush=True)


if __name__ == "__main__":
    main()
