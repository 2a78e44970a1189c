"""The step cost model (port of ``repro.launch.hlo_cost``).

The reference re-derives per-device FLOPs and HBM bytes from the
optimized HLO text of a compiled step, with while-loop trip-count
multipliers, because XLA's own cost analysis visits a ``lax.scan`` body
once. Torch has no HLO. The port runs the step itself, on ``meta``
tensors (nothing is allocated or computed), and ``StepCost``, a
``TorchDispatchMode``, counts every ATen op that reaches a device
tensor:

* FLOPs: ``torch.utils.flop_counter``'s formula where it has one (mm,
  bmm, addmm, convolution, attention); otherwise one per output element
  of a pointwise op, one per input element of a reduction, one per
  update element of a scatter (``index_add``, ``index_put`` with
  accumulate, the embedding backward), as the reference's model counts
  kLoop fusions, reduces and scatters.
* bytes: operand plus output bytes of each op, skipping views and other
  metadata ops (the counterpart of the reference's ``_METADATA_OPS``)
  and allocations that write nothing; sliced access as the reference
  charges it: a gather (``embedding``, ``index_select``, ``index``,
  ``gather``) twice its output, a scatter twice its updates and indices
  plus the target it makes (none when it writes in place). The port runs eagerly, one kernel
  per op, so this is the traffic of its own execution; XLA fuses
  elementwise chains into one pass, so the reference's count is lower
  for the same function (``tests/test_torch_dryrun.py`` states the
  ratio).
* a hand-written kernel called on ``meta`` tensors (K3, GIN's
  aggregation) is no ATen op: it counts itself through
  ``count_kernel`` (its operands, output and workspace bytes).
* collectives: per-device output bytes by kind of each
  ``_c10d_functional`` collective (what DTensor emits on the dry-run's
  process group), and the bytes each moves under the ring model of the
  reference's ``HloModule.collective_bytes`` (an all-reduce twice its
  output, a reduce-scatter its input, the others their output).

No trip counts are needed: the port's models run their layers, attention
chunks and vocab chunks in Python loops, so every iteration's ops are
dispatched and counted. Under DTensor an op reaches the mode twice: once
at global shapes inside the sharding propagator (under a fake-tensor
mode, skipped) and once on the local shard (counted), so the counts are
one device's. Factory calls from the model's code that ask for the CPU
get ``meta`` instead: a model makes its masks and accumulators on its
input's device, which for a DTensor on the CPU mesh is the CPU.
"""
from __future__ import annotations

import contextlib
import os
import sys
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that read or write no data: views, metadata, allocation
_METADATA_OPS = {
    aten.detach, aten.alias, aten.lift_fresh, aten.empty, aten.empty_like,
    aten.empty_strided, aten.new_empty, aten.new_empty_strided,
    aten._local_scalar_dense, aten.sym_size, aten.sym_stride,
    aten.sym_numel, aten.sym_storage_offset, aten.set_, aten._unsafe_view,
}

# sliced access, charged as the reference's ``HloModule.bytes_accessed``
# charges gather and scatter: a gather twice its output (rows read and
# written), not its whole table; a scatter twice its updates and indices,
# plus its target once when it makes a new one
_GATHERS = {aten.embedding, aten.index_select, aten.index, aten.gather}

_REDUCTIONS = {
    aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
    aten.prod, aten.var, aten.std, aten.var_mean, aten.norm,
    aten.linalg_vector_norm, aten._foreach_norm, aten.logsumexp,
    aten.cumsum, aten.argmax, aten.argmin, aten.any, aten.all,
    aten._softmax, aten._log_softmax, aten._softmax_backward_data,
    aten._log_softmax_backward_data, aten.sort, aten.topk,
}

# scatters: one combine per update element (the last tensor operand)
_SCATTERS = {aten.index_add, aten.index_add_, aten.scatter_add,
             aten.scatter_add_, aten.index_put, aten.index_put_,
             aten.embedding_dense_backward, aten._index_put_impl_}
_SLICE_WRITES = _SCATTERS | {aten.index_copy, aten.index_copy_}

# pointwise ops not tagged so on every torch version (2.11 leaves
# leaky_relu untagged, and leaky_relu_backward is untagged everywhere)
_POINTWISE = {aten.leaky_relu, aten.leaky_relu_backward}

# copies and casts move bytes and compute nothing
_COPIES = {aten.clone, aten.copy, aten.copy_, aten._to_copy}

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = ("_c10d_functional", "c10d_functional")


def _tensors(x):
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _is_fake() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


_TORCH_DIR = os.path.dirname(torch.__file__) + os.sep
_DIST_DIR = _TORCH_DIR + "distributed" + os.sep


def _from_torch() -> bool:
    """Whether this op was called by torch.distributed's own code
    (DTensor's placement arithmetic wants real CPU index tensors) rather
    than the model's: the innermost caller outside torch's dispatch
    plumbing decides."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if not name.startswith(_TORCH_DIR) or name.startswith(_DIST_DIR):
            return name.startswith(_DIST_DIR)
        f = f.f_back
    return False


def _dtensor_type():
    dt = sys.modules.get("torch.distributed.tensor")
    return None if dt is None else dt.DTensor


_ACTIVE: list = []  # the StepCost modes entered, innermost last


def count_kernel(reads, writes, flops: float, extra_bytes: float = 0.0):
    """Count a hand-written kernel called on ``meta`` tensors (K3 in the
    dry-run: not an ATen op, so no mode sees it) in the innermost active
    ``StepCost``: the bytes of its ``reads`` and ``writes`` plus
    ``extra_bytes`` (its workspace), and ``flops``. A no-op outside one."""
    if not _ACTIVE or not _ACTIVE[-1].counting:
        return
    cost = _ACTIVE[-1]
    cost.bytes += float(sum(_nbytes(t) for t in list(reads) + list(writes))
                        + extra_bytes)
    cost.flops += float(flops)


class StepCost(TorchDispatchMode):
    """Counts one device's FLOPs, HBM bytes and collective bytes of the
    ATen ops run under it on ``meta`` tensors (see the module docstring).
    ``only(False)`` stops counting inside its block (the ranking sweep
    runs every shard's body in one process and counts shard 0's)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.collective_out: Dict[str, float] = {}
        self.collective_moved: Dict[str, float] = {}
        self.n_collective_ops = 0
        self.counting = True

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def only(self, counting: bool):
        old, self.counting = self.counting, bool(counting)
        try:
            yield
        finally:
            self.counting = old

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if dtensor is not None and any(issubclass(t, dtensor)
                                       for t in types):
            return NotImplemented  # DTensor dispatches the local op to us
        if _is_fake():             # sharding propagation at global shapes
            return func(*args, **kwargs)
        if func is aten.equal.default and any(
                t.device.type == "meta" for t in _tensors(args)):
            return True            # a consistency check: meta holds no data
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cpu" \
                and not _from_torch():
            kwargs = dict(kwargs, device=torch.device("meta"))
        out = func(*args, **kwargs)
        if self.counting:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if not any(t.device.type == "meta" for t in ins + outs):
            return  # host work (a CPU scalar), not the device's
        ns = func.namespace
        if ns in _C10D:
            kind = _COLLECTIVES.get(func._opname)
            if kind is None:
                return  # wait_tensor, wrappers
            self.add_collective(kind, sum(_nbytes(t) for t in outs),
                                _nbytes(ins[0]))
            return
        packet = func._overloadpacket
        if func.is_view or packet in _METADATA_OPS:
            return
        if packet in _GATHERS:
            self.bytes += 2.0 * sum(_nbytes(t) for t in outs)
        elif packet in _SLICE_WRITES:
            target = [] if packet is aten.embedding_dense_backward else \
                ins[:1]
            small = sum(_nbytes(t) for t in ins if not any(
                t is u for u in target))
            made = 0 if func._schema.is_mutable else \
                sum(_nbytes(t) for t in outs)
            self.bytes += 2.0 * small + made
        else:
            self.bytes += float(sum(_nbytes(t) for t in ins + outs))
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        elif packet in _SCATTERS:
            self.flops += float(ins[-1].numel())
        elif packet in _REDUCTIONS:
            self.flops += float(ins[0].numel()) if ins else 0.0
        elif packet in _POINTWISE or (torch.Tag.pointwise in func.tags
                                      and packet not in _COPIES):
            self.flops += float(sum(t.numel() for t in outs))

    def add_collective(self, kind: str, out_bytes, in_bytes=0):
        """One collective of ``kind`` with these per-device output (and,
        for a reduce-scatter, input) bytes."""
        ob = float(out_bytes)
        moved = {"all-reduce": 2.0 * ob,
                 "reduce-scatter": float(in_bytes)}.get(kind, ob)
        self.collective_out[kind] = self.collective_out.get(kind, 0.0) + ob
        self.collective_moved[kind] = (self.collective_moved.get(kind, 0.0)
                                       + moved)
        self.n_collective_ops += 1

    def collectives(self) -> dict:
        """The reference's ``collective_bytes`` dict: ``total_bytes`` and
        ``by_kind`` in moved bytes (what the roofline prices), with the
        per-device output bytes beside them."""
        return {"total_bytes": sum(self.collective_moved.values()),
                "by_kind": dict(self.collective_moved),
                "output_bytes_by_kind": dict(self.collective_out),
                "n_collective_ops": self.n_collective_ops}
