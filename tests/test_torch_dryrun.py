"""The port's dry-run and roofline tools (``repro_torch.launch.dryrun``,
``steps``, ``hlo_cost``, ``hlo_analysis``, ``mesh`` and the spec
metadata) against the JAX package's, on the CPU:

* the spec trees leaf by leaf (``param_specs``, ``cache_specs``, the
  recsys ``*_specs``, ``opt_state_specs``) and ``filter_spec`` over the
  pod1, pod2 and (2, 4) meshes;
* ``build_step``'s ``meta``, arguments (shapes and dtypes) and in_specs
  for every non-skipped registry cell and the listed modes;
* the cost model against the reference's ``HloModule`` on the functions
  of ``tests/test_metrics_and_cost.py``;
* thirteen model cells (``HELD``) on (2, 4), (2, 16) and (16, 2) meshes
  against the reference's compiled HLO on 8 or 32 forced host devices
  (per-device FLOPs in a band, collective bytes by kind at stated
  ratios), their collectives pinned (``chip_smoke.DRYRUN_PINNED``, run
  ``strict``: no redistribution chosen by DTensor), the dry-run's rules
  one by one (an uneven hint, a checkpointed stack's one gather a weight
  for its recompute and backward, and the in-batch logits' split against
  the reference's HLO among them), a
  mirror of ``tests/test_dist.py``'s ``MINI_DRYRUN`` and a one-device
  host cell (subprocesses; the port's make and destroy fake process
  groups);
* the ranking cells' collective bytes against the reference's
  ``hlo_analysis.collective_bytes`` reading of ``make_dryrun_rank_sweep``
  over 8 forced host devices (a subprocess);
* ``benchmarks/roofline_report.py`` (imported from its file, unedited)
  reading the port's JSONs, and ``run_cell``'s cache rule;
* GIN's aggregation on ``meta`` edges: K3's layouts at their largest
  size for the edge count, and K3's counted traffic.
"""
import dataclasses
import functools
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import REGISTRY as RREG
from repro.launch import steps as rsteps
from repro.launch.hlo_cost import HloModule
from repro.models import recsys as rrs
from repro.models import sharding as rsh
from repro.models import transformer as rtf
from repro.train.optimizer import opt_state_specs as r_opt_specs
from repro_torch.configs import REGISTRY as PREG
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import steps as psteps
from repro_torch.launch.hlo_cost import StepCost
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import gnn as pg
from repro_torch.models import recsys as prs
from repro_torch.models import sharding as psh
from repro_torch.models import transformer as ptf
from repro_torch.sparse.dist import Mesh
from repro_torch.train.optimizer import opt_state_specs as p_opt_specs
from repro_torch.tree import leaves as pleaves

ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LM = [a for a, s in PREG.items() if s.family == "lm"]
RECSYS = [a for a, s in PREG.items() if s.family == "recsys"]
SPEC_FNS = {prs.DLRMConfig: ("dlrm_specs", rrs.dlrm_specs),
            prs.DCNConfig: ("dcn_specs", rrs.dcn_specs),
            prs.BSTConfig: ("bst_specs", rrs.bst_specs),
            prs.TwoTowerConfig: ("twotower_specs", rrs.twotower_specs)}
# (mode, arch, shape): the reference's dry-run modes
MODES = [("moe_cshard", "mixtral-8x7b", "train_4k"),
         ("moe_vshard", "deepseek-v2-236b", "train_4k"),
         ("remat_dots", "deepseek-7b", "train_4k"),
         ("attn_chunk=512", "minitron-8b", "prefill_32k"),
         ("dp_subgraphs", "gin-tu", "minibatch_lg"),
         ("dp_subgraphs+onehot", "gin-tu", "minibatch_lg"),
         ("dual_blocked", "hits-webgraph", "webrank_200m"),
         ("dual_blocked+compact+bf16", "hits-webgraph", "webrank_multi")]


def ref_specs(tree):
    return [tuple(x) for x in
            jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))]


def port_specs(tree):
    return [tuple(x) for x in pleaves(tree)]


def port_recsys_specs(cfg):
    return getattr(prs, SPEC_FNS[type(cfg)][0])(cfg)


# ------------------------------------------------------------- spec trees
@pytest.mark.parametrize("arch", LM)
def test_lm_spec_trees(arch):
    """``param_specs``, ``cache_specs`` and ``opt_state_specs`` leaf by
    leaf, in the trees' order."""
    pc, rc = PREG[arch].config, RREG[arch].config
    pairs = [(ptf.param_specs(pc), rtf.param_specs(rc)),
             (ptf.cache_specs(pc), rtf.cache_specs(rc)),
             (p_opt_specs(ptf.param_specs(pc)),
              r_opt_specs(rtf.param_specs(rc)))]
    for mine, ref in pairs:
        assert port_specs(mine) == ref_specs(ref)
    # the spec tree has a leaf for every parameter
    assert len(port_specs(ptf.param_specs(pc))) == \
        len(pleaves(ptf.param_shapes(pc)))


@pytest.mark.parametrize("arch", RECSYS)
def test_recsys_spec_trees(arch):
    pc, rc = PREG[arch].config, RREG[arch].config
    mine = port_recsys_specs(pc)
    ref = SPEC_FNS[type(pc)][1](rc)
    assert port_specs(mine) == ref_specs(ref)
    assert port_specs(p_opt_specs(mine)) == ref_specs(r_opt_specs(ref))
    model = prs.build(pc, device="meta")
    assert len(port_specs(mine)) == len(pleaves(model.to_tree()))


MESHES = {"pod1": lambda: make_production_mesh(),
          "pod2": lambda: make_production_mesh(multi_pod=True),
          "2x4": lambda: Mesh(("meta",) * 8, (2, 4), ("data", "model"))}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_filter_spec(mesh_name):
    """``tree_filter_specs`` of every LM and recsys spec tree (and the
    reference's data-parallel batch spec) equals the reference's on a
    mesh with the same axis names."""
    mesh = MESHES[mesh_name]()
    ref_mesh = SimpleNamespace(axis_names=mesh.axes)
    trees = []
    for arch in LM:
        pc, rc = PREG[arch].config, RREG[arch].config
        trees += [(ptf.param_specs(pc), rtf.param_specs(rc)),
                  (ptf.cache_specs(pc), rtf.cache_specs(rc))]
    for arch in RECSYS:
        pc, rc = PREG[arch].config, RREG[arch].config
        trees.append((port_recsys_specs(pc), SPEC_FNS[type(pc)][1](rc)))
    trees.append(({"b": psh.P(psh.DP, None)}, {"b": JP(rsh.DP, None)}))
    for mine, ref in trees:
        got = port_specs(psh.tree_filter_specs(mine, mesh))
        want = ref_specs(jax.tree.map(
            lambda s: rsh.filter_spec(s, ref_mesh), ref,
            is_leaf=lambda s: isinstance(s, JP)))
        assert got == want


def test_partition_spec_and_hint():
    """``P`` is a tree leaf that reads as its entries; ``shard_hint`` is
    the identity on a plain tensor."""
    s = psh.P(psh.DP, None, "model")
    assert tuple(s) == (("pod", "data"), None, "model") and len(s) == 3
    assert s == psh.P(("pod", "data"), None, "model") and s[2] == "model"
    assert pleaves({"a": s, "b": (psh.P(), psh.P(None))}) == \
        [s, psh.P(), psh.P(None)]
    x = torch.ones(3)
    assert psh.shard_hint(x, psh.DP) is x
    mesh = make_production_mesh()
    assert psh.filter_spec(s, mesh) == psh.P("data", None, "model")
    assert mesh.size == 256 and {d.type for d in mesh.devices} == {"meta"}
    assert make_production_mesh(multi_pod=True).shape == (2, 16, 16)
    host = make_host_mesh(device="cpu")
    assert host.shape == (1, 1) and host.axes == ("data", "model")


# ---------------------------------------------------------------- the steps
def ref_args(step):
    return [(tuple(x.shape), str(x.dtype)) for x in jax.tree.leaves(step.args)]


def port_args(step):
    out = []
    for a in step.args:
        out += pleaves(a.to_tree() if hasattr(a, "to_tree") else a)
    return out


def same_step(mine, ref):
    assert mine.meta == ref.meta
    assert mine.name == ref.name
    got = port_args(mine)
    assert [(tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for x in got] == ref_args(ref)
    # nothing is allocated: every argument is meta but the host scalars
    # (the optimizer's step, the decode position)
    host = [x for x in got if x.device.type != "meta"]
    assert all(x.dim() == 0 and x.device.type == "cpu" for x in host)
    assert len(host) <= 1
    assert [port_specs(s) for s in mine.in_specs] == \
        [ref_specs(s) for s in ref.in_specs]


@pytest.mark.parametrize("arch", list(PREG))
def test_build_step_matches_reference(arch):
    """Every non-skipped shape of the arch: ``meta`` (the model FLOPs),
    the arguments' shapes and dtypes, the in_specs."""
    spec, rspec = PREG[arch], RREG[arch]
    for shape in spec.shapes:
        if spec.skip_shapes.get(shape):
            continue
        same_step(psteps.build_step(spec, shape),
                  rsteps.build_step(rspec, shape))


@pytest.mark.parametrize("mode,arch,shape", MODES)
def test_build_step_modes(mode, arch, shape):
    same_step(psteps.build_step(PREG[arch], shape, mode=mode),
              rsteps.build_step(RREG[arch], shape, mode=mode))


def test_registry_cell_count():
    """43 cells, 4 skipped (``long_500k`` of the full-attention LMs): the
    39 the dry-run runs."""
    cells = [(a, s) for a, spec in PREG.items() for s in spec.shapes]
    skipped = [(a, s) for a, s in cells if PREG[a].skip_shapes.get(s)]
    assert len(cells) == 43 and len(skipped) == 4
    assert {s for _, s in skipped} == {"long_500k"}


# --------------------------------------------------------------- cost model
def _m(*shape):
    return torch.empty(shape, device="meta")


def test_cost_matches_hlo_cost_loop_free():
    """``(a @ b) @ c + sum(a)``: FLOPs within 5 % of the reference's
    ``HloModule`` (measured: 41,984,000 against 41,984,065). Bytes:
    measured 1,540,104 against 1,540,368 (ratio 0.99983): XLA fuses the
    broadcast add into the second product's output, which the port's
    eager ``add`` reads and writes once more, while the reference counts
    the sum's reduce fusion and the entry's parameters a little higher;
    held to 0.95-1.05."""
    def f(a, b, c):
        return (a @ b) @ c + jax.numpy.sum(a)
    A = jax.ShapeDtypeStruct((128, 256), jax.numpy.float32)
    B = jax.ShapeDtypeStruct((256, 512), jax.numpy.float32)
    C = jax.ShapeDtypeStruct((512, 64), jax.numpy.float32)
    mod = HloModule(jax.jit(f).lower(A, B, C).compile().as_text())
    with StepCost() as cost:
        a = _m(128, 256)
        (a @ _m(256, 512)) @ _m(512, 64) + a.sum()
    assert abs(cost.flops - mod.flops()) / mod.flops() < 0.05
    assert 0.95 < cost.bytes / mod.bytes_accessed() < 1.05


def test_cost_scales_with_layers():
    """A Python loop of L ``tanh(x @ w)`` layers: every iteration is
    counted, no trip count needed (4 layers 3.5-4.5x one). Against the
    reference's scan: FLOPs within 5 % at both lengths; bytes equal at
    one layer, 0.571x at four (the scan's per-iteration dynamic slice of
    the stacked weights and carry copies, which the port's loop over
    views does not make)."""
    def g(ws, x):
        def body(x, w):
            return jax.numpy.tanh(x @ w), None
        return jax.lax.scan(body, x, ws)[0]
    flops, ref = {}, {}
    for L in (1, 4):
        mod = HloModule(jax.jit(g).lower(
            jax.ShapeDtypeStruct((L, 128, 128), jax.numpy.float32),
            jax.ShapeDtypeStruct((64, 128), jax.numpy.float32))
            .compile().as_text())
        with StepCost() as cost:
            x = _m(64, 128)
            for w in _m(L, 128, 128):
                x = torch.tanh(x @ w)
        flops[L] = cost.flops
        ref[L] = mod
        assert abs(cost.flops - mod.flops()) / mod.flops() < 0.05
    assert 3.5 < flops[4] / flops[1] < 4.5
    assert cost.bytes / ref[4].bytes_accessed() < 1.0


def test_cost_skips_views_and_host_scalars():
    with StepCost() as cost:
        x = _m(64, 32)
        x.t().t().reshape(-1).view(32, 64)[:, :3].unsqueeze(0).expand(2, 32, 3)
        assert int(torch.tensor(3) + 1) == 4  # host work, not counted
    assert cost.flops == 0 and cost.bytes == 0
    with StepCost() as cost:
        x.t().contiguous()  # a copy: bytes, no FLOPs
    assert cost.flops == 0 and cost.bytes == 2 * 64 * 32 * 4
    with StepCost() as cost:
        z = torch.zeros((16, 8), device="cpu")  # a model's CPU factory
    assert z.device.type == "meta"


def test_roofline_hardware_sets():
    rl = hlo_analysis.Roofline(989e12, 3.35e12, 450e9, 8, 8 * 989e12)
    assert rl.compute_s == pytest.approx(1.0) and rl.memory_s == \
        pytest.approx(1.0) and rl.collective_s == pytest.approx(1.0)
    assert rl.roofline_fraction == pytest.approx(1.0)
    v5e = hlo_analysis.Roofline(197e12, 819e9, 50e9, 1, 0.0,
                                hlo_analysis.hardware("tpu-v5e"))
    assert v5e.step_time_s == pytest.approx(1.0)
    assert set(rl.to_dict()) == {
        "flops_per_device", "hbm_bytes_per_device",
        "collective_bytes_per_device", "n_devices", "model_flops",
        "compute_s", "memory_s", "collective_s", "bottleneck",
        "step_time_s", "useful_flops_ratio", "roofline_fraction"}
    with pytest.raises(KeyError):
        hlo_analysis.hardware("h200")


def test_collective_rate_by_mesh_size():
    """The H100's collectives run at NVLink's 450e9 B/s inside one 8-GPU
    board and at one NDR port's 50e9 B/s a GPU on a mesh that spans
    boards (pod1's 256 devices); the JSON names the rate and the link."""
    h100 = hlo_analysis.hardware("h100-sxm")
    assert h100.link_rate(8) == 450e9 and h100.link_rate(256) == 50e9
    assert h100.link_rate(1) == 450e9
    assert "NVLink" in h100.describe(8)["collective_link"]
    assert "NDR" in h100.describe(512)["collective_link"]
    rl = hlo_analysis.Roofline(0.0, 0.0, 50e9, 256)
    assert rl.collective_s == pytest.approx(1.0)
    assert hlo_analysis.Roofline(0.0, 0.0, 450e9, 8).collective_s == \
        pytest.approx(1.0)


# ------------------------------------------------ fake process group cells
# (arch, shape, mesh shape) of the cells held to the reference's compiled HLO
# on 8 (or, for (2, 16), 32) forced host devices: one at least of each family
# of redistributions the dry-run makes itself
HELD = [("minitron-4b", "train_4k", (2, 4)),
        ("gin-tu", "ogb_products", (2, 4)),
        ("dlrm-rm2", "train_batch", (2, 4)),
        ("dlrm-rm2", "retrieval_cand", (2, 4)),          # a sharded sort
        ("two-tower-retrieval", "train_batch", (2, 4)),  # in-batch diagonal
        ("gin-tu", "minibatch_lg", (2, 4)),              # the seeds' slice
        ("deepseek-7b", "decode_32k", (2, 4)),   # a position-sharded cache
        ("mixtral-8x7b", "decode_32k", (2, 4)),          # MoE decode
        ("mixtral-8x7b", "prefill_32k", (2, 4)),         # MoE dispatch
        ("minitron-8b", "train_4k", (2, 16)),            # GQA over model=16
        ("mixtral-8x7b", "train_4k", (2, 4)),            # MoE training
        ("deepseek-v2-236b", "train_4k", (2, 4)),        # experts on model
        # the capacity (327,688) over data=16: the buffer sharded unevenly
        ("mixtral-8x7b", "train_4k", (16, 2))]

# a held cell's name: "arch shape", and its mesh off (2, 4) and (2, 16)
cell_id = _chip_smoke().pin_name
CELL_IDS = [cell_id(*c) for c in HELD]
# the port's cells run in five processes at once (the slowest alone)
ALONE = {"mixtral-8x7b prefill_32k": "port_moe",
         "minitron-8b train_4k": "port_gqa",
         "mixtral-8x7b train_4k": "port_moe_train",
         "mixtral-8x7b train_4k 16x2": "port_moe_train",
         "deepseek-v2-236b train_4k": "port_experts"}
PORT_GROUPS = {g: [c for c, i in zip(HELD, CELL_IDS) if ALONE.get(i, "port")
                   == g] for g in ("port", "port_moe", "port_gqa",
                                   "port_moe_train", "port_experts")}

FAKE_GROUP = r"""
import json, sys
from repro_torch.configs import get_spec
from repro_torch.launch import dryrun
from repro_torch.launch.steps import build_step
from repro_torch.sparse.dist import Mesh
out = {"cells": {}}
for arch, shape, mshape, name in json.loads(sys.argv[2]):
    mesh = Mesh(("meta",) * (mshape[0] * mshape[1]), tuple(mshape),
                ("data", "model"))
    out["cells"][name] = dryrun.model_cell(
        build_step(get_spec(arch), shape), mesh, "h100-sxm", strict=True)
if sys.argv[3] != "extras":
    print(json.dumps(out))
    sys.exit()
mesh = Mesh(("meta",) * 8, (2, 4), ("data", "model"))
out["host"] = dryrun.run_cell("gin-tu", "full_graph_sm", "host", sys.argv[1],
                              device="cpu")
# the dry-run's own rules on a (2, 4) mesh: a lookup in a row-sharded table
# and a KV-cache write into a position-sharded cache
import torch
import torch.nn.functional as F
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.models.sharding import P
rules = {}
def record(name, t, cost):
    rules[name] = {"coll": cost.collectives()["output_bytes_by_kind"],
                   "pl": str(tuple(t.placements)),
                   "local": list(t.to_local().shape)}
def place(shape, spec, dm, dtype=torch.float32):
    return dryrun._place(torch.empty(shape, dtype=dtype, device="meta"),
                         P(*spec), dm, mesh)
with dryrun.fake_device_mesh(mesh) as dm:
    table = place((64, 16), ("model", None), dm)
    ids = place((32,), ("data",), dm, torch.long)
    cache = place((4, 8, 2), ("data", "model", None), dm)
    new = place((4, 1, 2), ("data", None, None), dm)
    cost = dryrun.ShardedCost()
    with implicit_replication(), cost:
        e = F.embedding(ids.long() % 8, table.detach())
        record("lookup", e, cost)
        cache.index_copy_(1, torch.tensor([5]), new)
        record("cache", cache, cost)
    # a sort along a model-sharded dim (the retrieval top-k)
    x = place((16, 32), ("data", "model"), dm)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
        record("sort", idx, cost)
    # GIN's seeds: the first 16 of 64 data-sharded rows, and the backward
    h = place((64, 8), ("data", None), dm)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("slice", h[:16], cost)
    g = place((16, 8), ("data", None), dm)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("slice_backward", torch.ops.aten.slice_backward(
            g, [64, 8], 0, 0, 16, 1), cost)
    # a scatter into a plain zeros target (as a backward formula makes
    # one) by data-sharded indices and updates
    idx = place((16, 2), ("data", None), dm, torch.long)
    src = place((16, 2), ("data", None), dm)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("scatter", torch.ops.aten.scatter.src(
            torch.zeros(16, 8), 1, idx, src), cost)
    # lookups: along an unsharded dim with an index sharded alike, along
    # a model-sharded dim with a replicated index, x[idx] of data-sharded
    # rows; and the diagonal of a row-sharded square
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("gather", place((16, 8), ("data", None), dm).gather(
            1, place((16, 2), ("data", None), dm, torch.long)), cost)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("gather_masked", place((4, 32), (None, "model"), dm).gather(
            1, place((4, 3), (None, None), dm, torch.long)), cost)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("index", place((32,), ("data",), dm, torch.long)[
            place((32,), (None,), dm, torch.long)], cost)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        record("diagonal", place((16, 16), ("data", None), dm).diagonal(),
               cost)
    # decode: model-sharded query heads against a model-sharded cache's
    # positions, then the contraction over the positions
    q = place((4, 8, 16), ("data", "model", None), dm)
    k = place((4, 32, 16), ("data", "model", None), dm)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        s = torch.einsum("bhd,bsd->bhs", q, k)
        record("decode_scores", s, cost)
        o = torch.einsum("bhs,bsd->bhd", s, k)
        record("decode_out", o, cost)
    # a product of operands sharded against each other along one mesh dim
    # both by a free dim: a broadcast add DTensor must place itself, which
    # strict refuses and the default records
    a = place((16, 32), ("data", "model"), dm)
    b = place((32,), ("data",), dm)
    try:
        with implicit_replication(), dryrun.ShardedCost(strict=True):
            a + b
        out["strict"] = "no error"
    except RuntimeError as err:
        out["strict"] = str(err)
    lax = dryrun.ShardedCost()
    with implicit_replication(), lax:
        a + b
    out["lax"] = {f"{op} {kind}": v for (op, kind), v in lax.implicit.items()}
    # a two-layer checkpointed stack of (16, 16) f32 weights sharded
    # FSDP-style (the contraction over data), on data-sharded (64, 16) rows
    from torch.utils.checkpoint import checkpoint
    from repro_torch.models.sharding import DP, remat_context, shard_hint
    ws = place((2, 16, 16), (None, "data", None), dm).requires_grad_()
    x = place((64, 16), ("data", None), dm)
    cost = dryrun.ShardedCost(strict=True)
    cost.hold_weights([ws])
    gathers, add = [], cost.add_collective
    def counted(kind, out_b, in_b=0):
        if kind == "all-gather":
            gathers.append(out_b)
        add(kind, out_b, in_b)
    cost.add_collective = counted
    with implicit_replication(), cost:
        h = x
        for i in range(2):
            h = checkpoint(lambda h, w: torch.tanh(h @ w), h, ws[i],
                           use_reentrant=False, context_fn=remat_context())
        torch.autograd.grad(h.sum(), [ws])
    rules["recompute_gather"] = {"n": len(gathers), "bytes": sum(gathers)}
    # the two-tower's in-batch logits at (256, 32) f32 through a (32, 32)
    # tower: the items hinted onto model and gathered (the model's hints),
    # and items replicated all along; FLOPs of the products (mm) alone
    class Products(dryrun.ShardedCost):
        def _carry(self, x, want, kinds=None):
            f = self.flops
            x = super()._carry(x, want, kinds)
            self.dot_flops += self.flops - f
            return x
    mm = dryrun._RULES[torch.ops.aten.mm]
    def counted_mm(cost, func, args, kwargs):
        f = cost.flops
        y = mm(cost, func, args, kwargs)
        cost.dot_flops += cost.flops - f
        return y
    dryrun._RULES[torch.ops.aten.mm] = counted_mm
    for name, vspec in (("inbatch_split", ("data", None)),
                        ("inbatch_replicated", (None, None))):
        u0 = place((256, 32), ("data", None), dm).requires_grad_()
        v0 = place((256, 32), vspec, dm).requires_grad_()
        w = place((32, 32), (None, None), dm)
        cost = Products(strict=True)
        cost.dot_flops = 0.0
        with implicit_replication(), cost:
            u, v = torch.tanh(u0 @ w), torch.tanh(v0 @ w)
            if name == "inbatch_split":
                v = shard_hint(shard_hint(v, "model", None), None, None)
            logits = shard_hint(u @ v.T, DP, None)
            loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
            torch.autograd.grad(loss, [u0, v0])
        rules[name] = {"coll": cost.collectives()["by_kind"],
                       "dot_flops": cost.dot_flops}
    dryrun._RULES[torch.ops.aten.mm] = mm
# grouped-query heads over model=16 factored (8, 2): 32 heads into 8 groups
big = Mesh(("meta",) * 32, (2, 16), ("data", "model"))
with dryrun.fake_device_mesh(big, (8, 2)) as dm:
    q = dryrun._place(torch.empty(2, 4, 32, 8, device="meta"),
                      P("data", None, "model", None), dm, big)
    kv = dryrun._place(torch.empty(2, 6, 8, 8, device="meta"),
                       P("data", None, None, None), dm, big)
    with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
        qg = q.reshape(2, 4, 8, 4, 8)
        record("gqa_view", qg, cost)
        sc = torch.einsum("bqhgd,bkhd->bqhgk", qg, kv)
        record("gqa_scores", sc, cost)
        record("gqa_merge", torch.einsum("bqhgk,bkhd->bqhgd", sc, kv)
               .reshape(2, 4, 32, 8), cost)
# an uneven hint on a (4, 2) mesh: (10, 16) f32 hinted to ("data", None)
# (4 does not divide 10), from a replicated value and from a partial sum
# (a product over data-sharded contraction), each gathered back after
from repro_torch.models.sharding import shard_hint
m42 = Mesh(("meta",) * 8, (4, 2), ("data", "model"))
with dryrun.fake_device_mesh(m42) as dm:
    def f32(shape, spec):
        return dryrun._place(torch.empty(shape, device="meta"), P(*spec), dm,
                             m42)
    for name, args in (("uneven_hint", [f32((10, 16), (None, None))]),
                       ("uneven_reduce", [f32((10, 8), (None, "data")),
                                          f32((8, 16), ("data", None))])):
        with implicit_replication(), dryrun.ShardedCost(strict=True) as cost:
            x = args[0] * 2 if len(args) == 1 else args[0] @ args[1]
            y = torch.sin(shard_hint(x, "data", None))
            z = shard_hint(torch.cos(y), None, None)
        rules[name] = {"local": list(y.to_local().shape),
                       "pl": str(tuple(y.placements)),
                       "coll": cost.collectives()["by_kind"],
                       "out": [list(z.shape), list(z.to_local().shape)]}
out["rules"] = rules
out["factors"] = [dryrun.model_axis_factors(get_spec(a).config, m) for a, m
                  in (("minitron-8b", big), ("minitron-8b", mesh),
                      ("deepseek-7b", big), ("mixtral-8x7b", big))]
import torch.distributed as dist
out["group_left"] = dist.is_initialized()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def subprocs(tmp_path_factory):
    """The file's subprocesses, started together: the port's fake group
    cells (three processes), the reference's model cells on 8 and on 32
    forced host devices, and its ranking cells."""
    d = tmp_path_factory.mktemp("dryrun_cells")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref_env = dict(env, JAX_PLATFORMS="cpu")

    def start(argv, e):
        return subprocess.Popen([sys.executable, "-c"] + argv, env=e,
                                text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
    procs = {name: start([FAKE_GROUP, str(d), json.dumps(
        [list(c) + [cell_id(*c)] for c in cells]),
        "extras" if name == "port" else ""], env)
        for name, cells in PORT_GROUPS.items()}
    for n in (8, 32):
        cells = [list(c) + [cell_id(*c)] for c in HELD
                 if c[2][0] * c[2][1] == n]
        procs[f"ref_model_{n}"] = start(
            [REF_MODEL, str(n), json.dumps(cells)], ref_env)
    procs["ref_rank"] = start([REF_RANK, json.dumps(RANK_SHAPES),
                               json.dumps(REF_CELLS)], ref_env)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


def _last_json(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_group_cells(subprocs):
    out = _last_json(subprocs["port"])
    for name in PORT_GROUPS:
        if name != "port":
            out["cells"].update(_last_json(subprocs[name])["cells"])
    return out


REF_MODEL = r"""
import os, json, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count="
                           + sys.argv[1])
import jax
from repro.compat import make_mesh, set_mesh
from repro.configs import get_spec
from repro.launch import hlo_analysis
from repro.launch.dryrun import _to_named
from repro.launch.hlo_cost import HloModule
from repro.launch.steps import build_step
out = {}
for arch, shape, mshape, name in json.loads(sys.argv[2]):
    mesh = make_mesh(tuple(mshape), ("data", "model"))
    step = build_step(get_spec(arch), shape)
    with set_mesh(mesh):
        comp = jax.jit(step.fn, in_shardings=_to_named(
            step.in_specs, mesh, step.args)).lower(*step.args).compile()
        a = hlo_analysis.analyze(comp, step.meta["model_flops_per_step"],
                                 int(sys.argv[1]))
    # the HLO model's FLOPs without its kLoop fusions (one an output
    # element): on the CPU backend these carry its bf16 <-> f32 converts
    text = comp.as_text().replace("kind=kLoop", "kind=kNotCounted")
    out[name] = {"roofline": a["roofline"],
                 "by_kind": a["collectives"]["by_kind"],
                 "flops_no_loop": HloModule(text).flops()}
if sys.argv[1] == "8":
    # an uneven hint on a (4, 2) mesh: (10, 16) f32 on ("data", None),
    # from a replicated value and from a partial sum, each gathered back
    import re
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as JP
    from repro.models.sharding import shard_hint
    mesh = make_mesh((4, 2), ("data", "model"))
    f32 = jnp.float32
    def hinted(x):
        y = jnp.sin(shard_hint(x * 2, "data", None))
        return shard_hint(jnp.cos(y), None, None)
    def reduced(a, b):
        y = jnp.sin(shard_hint(a @ b, "data", None))
        return shard_hint(jnp.cos(y), None, None)
    rules = {}
    with set_mesh(mesh):
        for name, fn, args, specs in (
                ("uneven_hint", hinted, [(10, 16)], [JP()]),
                ("uneven_reduce", reduced, [(10, 8), (8, 16)],
                 [JP(None, "data"), JP("data", None)])):
            text = jax.jit(fn, in_shardings=tuple(
                NamedSharding(mesh, s) for s in specs)).lower(
                *[jax.ShapeDtypeStruct(a, f32) for a in args]).compile(
                ).as_text()
            local = re.search(r"= f32\[([\d,]*)\]\S* sine\(", text).group(1)
            rules[name] = {"local": [int(n) for n in local.split(",")],
                           "coll": HloModule(text).collective_bytes()[
                               "by_kind"]}
    # a two-layer stack of FSDP weights under jax.checkpoint over lax.scan
    from repro.launch.hlo_cost import _OP_LINE
    mesh = make_mesh((2, 4), ("data", "model"))
    def stack(ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(jax.checkpoint(
            body, policy=jax.checkpoint_policies.nothing_saveable), x, ws)
        return h.sum()
    with set_mesh(mesh):
        text = jax.jit(jax.grad(stack), in_shardings=(
            NamedSharding(mesh, JP(None, "data", None)),
            NamedSharding(mesh, JP("data", None)))).lower(
            jax.ShapeDtypeStruct((2, 16, 16), f32),
            jax.ShapeDtypeStruct((64, 16), f32)).compile().as_text()
    mod = HloModule(text)
    rules["recompute_gather"] = {
        "n": sum(mod.mult.get(c, 0.0) for c, lines in mod.comps.items()
                 for line in lines if (m := _OP_LINE.match(line))
                 and m.group(3) in ("all-gather", "all-gather-start")),
        "bytes": mod.collective_bytes()["by_kind"]["all-gather"]}
    # the two-tower's in-batch logits (the reference's loss, no hint on the
    # items: XLA's own choice); FLOPs of the dots alone
    from repro.models.sharding import DP
    def towers(u0, v0, w):
        u, v = jnp.tanh(u0 @ w), jnp.tanh(v0 @ w)
        logp = jax.nn.log_softmax(shard_hint(u @ v.T, DP, None), axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.arange(u.shape[0])[:, None], axis=-1))
    for name, vspec in (("inbatch_split", JP("data", None)),
                        ("inbatch_replicated", JP(None, None))):
        with set_mesh(mesh):
            text = jax.jit(jax.grad(towers, argnums=(0, 1)), in_shardings=(
                NamedSharding(mesh, JP("data", None)),
                NamedSharding(mesh, vspec), NamedSharding(mesh, JP()))).lower(
                jax.ShapeDtypeStruct((256, 32), f32),
                jax.ShapeDtypeStruct((256, 32), f32),
                jax.ShapeDtypeStruct((32, 32), f32)).compile().as_text()
        mod = HloModule(text)
        rules[name] = {"coll": mod.collective_bytes()["by_kind"],
                       "dot_flops": mod.flops() - HloModule(
                           text.replace(" dot(", " dot_(")).flops()}
    out["rules"] = rules
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_model_cells(subprocs):
    out = _last_json(subprocs["ref_model_8"])
    out.update(_last_json(subprocs["ref_model_32"]))
    return out


def test_mini_dryrun(fake_group_cells):
    """``MINI_DRYRUN``'s assertions on the port: minitron-4b ``train_4k``
    on a (2, 4) mesh communicates (tensor parallelism) and its useful
    FLOP ratio is in (0, 1.5]."""
    mini = fake_group_cells["cells"]["minitron-4b train_4k"]
    rl = mini["roofline"]
    assert rl["flops_per_device"] > 0 and rl["hbm_bytes_per_device"] > 0
    assert rl["collective_bytes_per_device"] > 0
    assert 0 < rl["useful_flops_ratio"] <= 1.5, rl["useful_flops_ratio"]
    coll = mini["collectives"]
    assert coll["n_collective_ops"] > 0
    assert coll["total_bytes"] == rl["collective_bytes_per_device"]
    assert coll["by_kind"]["all-reduce"] == \
        2 * coll["output_bytes_by_kind"]["all-reduce"]
    assert not fake_group_cells["group_left"]


# minitron-4b's all-gathers: the port gathers its bf16 unembedding once
# (``loss_fn``'s hint: 3072 x 256,000 x 2 B) and the f32 gradients of wk
# and wv (heads sharded by the attention's backward) to their replicated
# parameters (2 x 32 x 3072 x 8 x 128 x 4 B); the reference's HLO gathers
# the f32 unembedding padded to 16 vocab chunks of 16,384 twice (the
# forward's and the transposed chunk scan's dynamic slices)
MINI_GATHER = 3072 * 256000 * 2 + 2 * 32 * 3072 * 8 * 128 * 4
MINI_REF_GATHER = 2 * 16 * 3072 * 16384 * 4
# minitron-8b on (2, 16) likewise, at d 4096 (its 8 KV heads replicated
# over model=16, so wk and wv are gathered whole: 2 x 32 layers x 4096 x 8
# x 128 x 4 B)
GQA_GATHER = 4096 * 256000 * 2 + 2 * 32 * 4096 * 8 * 128 * 4
GQA_REF_GATHER = 2 * 16 * 4096 * 16384 * 4


# per held cell: the bands of the port's FLOPs and HBM bytes over the
# reference's ("no_loop": over its FLOPs without kLoop fusions, see
# ``test_model_cell_matches_reference``); the default is FLOPs within 10 %
# and bytes 0.5-2.5x
BANDS = {"two-tower-retrieval train_batch": (0.85, 0.86, "all", 0.5, 2.5),
         "deepseek-7b decode_32k": (0.9, 1.1, "no_loop", 0.02, 0.04),
         "mixtral-8x7b decode_32k": (0.9, 1.1, "no_loop", 0.1, 0.15)}
# per held cell: each collective kind's bytes moved, port over reference:
# "equal", ("plus", n) (the port's exceeds by 0..n bytes), ("less", n)
# (exactly n bytes fewer), a (low, high) band, a float (exactly that
# fraction), "reference only" or ("port only", n) (exactly n bytes, a kind
# the reference's HLO does not hold)
COLL = {
    "gin-tu ogb_products": {"all-reduce": "equal", "all-gather": "equal"},
    "dlrm-rm2 train_batch": {"all-reduce": ("plus", 16)},
    "minitron-4b train_4k": {"all-reduce": (0.49, 0.52),
                             "all-gather": MINI_GATHER / MINI_REF_GATHER,
                             "collective-permute": "reference only"},
    "dlrm-rm2 retrieval_cand": {"all-reduce": "equal", "all-gather": "equal"},
    "two-tower-retrieval train_batch": {
        "all-gather": "equal", "collective-permute": "equal",
        "all-reduce": ("less", 2 * 16384 * 256 * 4 - 8)},
    "gin-tu minibatch_lg": {"all-gather": "equal", "all-reduce": ("plus", 16),
                            "collective-permute": "equal"},
    "deepseek-7b decode_32k": {"all-gather": 2 / 3,
                               "all-reduce": (0.66, 0.68)},
    "mixtral-8x7b decode_32k": {"all-gather": (0.50, 0.52),
                                "all-reduce": (0.5, 0.65),
                                "all-to-all": (0.47, 0.50),
                                "collective-permute": "reference only"},
    "mixtral-8x7b prefill_32k": {"all-gather": (0.4, 0.5),
                                 "all-reduce": (0.5, 0.6),
                                 "collective-permute": "reference only"},
    "minitron-8b train_4k": {"all-gather": GQA_GATHER / GQA_REF_GATHER,
                             "all-reduce": (0.49, 0.52),
                             "collective-permute": "reference only"},
    "mixtral-8x7b train_4k": {"all-gather": (0.46, 0.48),
                              "all-reduce": (0.47, 0.50),
                              "collective-permute": "reference only",
                              "reduce-scatter": ("port only", 65536000)},
    "deepseek-v2-236b train_4k": {"all-gather": (0.49, 0.495),
                                  "all-reduce": (0.28, 0.31),
                                  "collective-permute": "reference only",
                                  "reduce-scatter": ("port only",
                                                     262144000)},
    "mixtral-8x7b train_4k 16x2": {"all-gather": (0.51, 0.53),
                                   "all-reduce": (0.47, 0.50),
                                   "collective-permute": "reference only",
                                   "reduce-scatter": ("port only",
                                                      131072000)},
}


@pytest.mark.parametrize("cell", CELL_IDS)
def test_model_cell_matches_reference(cell, fake_group_cells,
                                      ref_model_cells):
    """Per device on a (2, 4) mesh ((2, 16) for minitron-8b, (16, 2) for
    the last), the port against the reference's compiled HLO (8 or 32
    forced host devices), run ``strict``: no redistribution chosen by
    DTensor. FLOPs within
    10 % (the port counts its eager ops by ``flop_counter``'s formulas,
    the reference its HLO ops), HBM bytes within 0.5-2.5x (both charge
    gathers and scatters alike, but XLA fuses elementwise chains and
    AdamW's passes where the port reads and writes at every eager op),
    the model FLOPs equal; collective bytes moved by kind (``COLL``):

    * gin-tu ogb_products: equal (an all-gather of the edges onto the
      data axis, one all-reduce of the (N, 64) f32 aggregation a layer
      forward and one backward);
    * dlrm-rm2 train_batch, gin-tu minibatch_lg: all-reduce equal but
      for 8 B (the f32 scalars the two reduce, the loss and the gradient
      norm's parts, differ by one);
    * minitron-4b train_4k: all-reduce 0.49-0.52 (measured 0.5011): the
      reference's CPU compiler promotes the bf16 activation all-reduces
      to f32 (``to_apply=%add.clone_promoted``), the port reduces them in
      bf16, and the f32 weight gradients' all-reduces are equal;
      all-gather as ``MINI_GATHER`` against ``MINI_REF_GATHER``; the
      reference's collective-permute (113,246,208 B, its vocab padding
      moved between shards) has no counterpart: the port pads its last
      chunk where it is;
    * minitron-8b train_4k, (2, 16), its "model" axis factored (8, 2) for
      the 32 query heads grouped into 8 KV groups (no gather at the
      view, as in the HLO): the same three statements, with
      ``GQA_GATHER`` against ``GQA_REF_GATHER`` and the reference's
      permute of 188,743,680 B (f32[4096,5760], its padded vocab);
    * dlrm-rm2 retrieval_cand: equal (the scores gathered along the
      candidates for the top-k sort, 4,000,000 B);
    * two-tower train_batch: the items' rows moved onto the model axis
      (the model's hint: a collective-permute of each device's quarter
      of the batch, f32[16384,256]) and gathered there (67,108,864 B),
      then the gradient's rows moved back to their data shards (a
      (32768, 256) block): all-gather and collective-permute (50,331,648
      B) equal. The backward products of the (B/2, B) in-batch logits
      split as XLA's (``_presplit``, the ``slice`` carry): ``g @ v`` along
      the items' model shards (XLA's ``dot.14``), its (B/2, 256) partial
      all-reduced over model; ``u.T @ g`` only the device's own item rows,
      its model shard's 16,384, where the reference's ``dot.7`` computes
      its data shard's 32,768 (on a (32768, 32768) slice of the logits'
      gradient), all-reduces them over data and permutes them. So FLOPs
      0.85-0.86 (measured 0.8570: the port's is 2.75e11 less, 2 x 16,384
      x 32,768 x 256; with it 0.987, the rest elementwise), and the
      all-reduce the reference's less 33,554,424 B (those rows' 2 x
      16,384 x 256 x 4 B, plus the 8 B of f32 scalars the port reduces
      once more);
    * gin-tu minibatch_lg: all-gather equal (no gather at the seeds'
      slice); collective-permute equal (the second data shard's seed rows
      moved from the first, forward and backward: 2 x 131,072 B);
    * deepseek-7b decode_32k: all-gather 2/3: the query heads gathered
      in f32 (1,048,576 B a layer) in both, the new K and V rows in bf16
      in the port and in f32 in the reference's CPU compile
      (``all-gather.10``/``.11`` f32[64,1,32,128]); all-reduce 0.66-0.68
      (measured 0.672): the softmax statistics and the f32 values'
      partial sums are equal, the out projection's and the MLP's bf16
      all-reduces are f32 there (``clone_promoted``). FLOPs against the
      reference's without its kLoop fusions (measured 1.0012): those are
      its CPU compile's f32 conversions of the bf16 cache, 90 % of its
      count. HBM bytes 0.02-0.04 (measured 0.0289): the reference's CPU
      compile rewrites the whole stacked 30-layer cache at each layer's
      one-position update, converting it between bf16 and f32
      (``dynamic-update-slice_convert_fusion`` and
      ``convert_dynamic-update-slice_fusion``, 77 % of its bytes), and
      transposes each layer's cache in f32 (20 %); the port writes one
      position and casts each layer's cache once;
    * mixtral-8x7b decode_32k: FLOPs as deepseek-7b's (measured 1.042);
      HBM bytes 0.10-0.15 (measured 0.125), the same cache rewrites.
      All-gather 0.50-0.52 (measured 0.5103): each layer's three expert
      weights gathered FSDP-style in both, bf16 in the port and f32 in the
      reference (22.55e9 against 45.10e9 B; the second product gathers
      w2 as the reference does, its output's hint carried back to it, no
      longer the activations), the attention projections' weights
      (0.81e9 B against 0.82e9: bf16, but wk and wv whole where the
      reference holds 2 of 8 KV heads a device) and the unembedding
      (0.13e9 in both). All-to-all 0.47-0.50 (measured 0.4848): the
      residual add's operand moved onto the tokens' shards, bf16 (128,
      4096) a layer against the reference's f32 (two f32[1,64,2048]
      halves a layer and once after the loop). All-reduce 0.5-0.65
      (measured 0.583): bf16 in the port, f32 in the reference. Its
      collective-permute (1,048,576 B) moves the router's FSDP shards
      (f32[1024,8]) before the router product; the port gathers the
      router there;
    * mixtral-8x7b prefill_32k (the MoE dispatch: a sorted, replicated
      routing, the tokens gathered into the buffer by a masked lookup
      and all-reduce, the combine's lookups likewise): all-gather 0.4-0.5
      (measured 0.467): the FSDP expert and attention weights and the top-k
      gates, f32 in the reference's CPU compile, bf16 in the port (the
      gates f32 in both); all-reduce 0.5-0.6 (measured 0.543), bf16
      against f32; the reference's collective-permutes move the router's
      and the embedding table's FSDP shards (f32[1024,8], f32[8000,2048])
      before their product and lookup, where the port gathers the router
      with the weights and looks the table up in its shards;
    * the MoE training cells, (2, 4) and (16, 2) mixtral-8x7b train_4k
      and (2, 4) deepseek-v2-236b train_4k, full depth. FLOPs within 10 %
      (measured 1.041, 1.006, 1.075), HBM bytes in the default band
      (0.626, 0.505, 0.614). On (16, 2) the capacity (327,688) does not
      divide over data=16: the buffer is sharded as XLA pads it,
      ceil(C / 16) = 20,481 rows a device (the reference's
      f32[8,20481,4096]), not gathered. Each FSDP weight is gathered
      once in the forward and once for a layer's recompute and backward
      together (``ShardedCost.recompute``'s memo), as the reference's
      backward loop body gathers each weight once for both its
      rematerialized forward and the transposes: the expert weights 6
      gathers a layer in both, bf16 in the port and f32 in the
      reference, the attention weights and the router 2 in both.
      All-gather, mixtral 0.46-0.48 on (2, 4) and 0.51-0.53 on (16, 2)
      (measured 0.4717, 0.5188): expert weights 45.10e9 against 90.19e9
      B (90.19e9 against 180.4e9), half; the reference also gathers its
      f32 lookup outputs outside the loop (``jvp(jit(_take))``, 17.18e9
      and 2.15e9 B) where the port gathers the bf16 embedding table's
      columns (65.5e6, 131.1e6 B); the rest (attention weights, gates,
      sort keys, the unembedding) is 8.66e9 against 6.71e9 B and 9.56e9
      against 9.99e9. deepseek-v2-236b (160 experts on model) 0.49-0.495
      (measured 0.4900): the buffer's gradient gathered along d onto the
      buffer's placement (1.208e12 B bf16 against the reference's f32
      ``add_any``, 2.416e12: the transposes use w1 and w3 in their FSDP
      shards, as the reference's do, though the recompute gathered
      them), w2 gathered for the second expert product (the hint on its
      output carried back to it, as XLA gathers w2: no (E, C, d) output
      gathered and reduce-scattered back), the expert weights 6 gathers a
      layer, bf16, against the reference's 6 f32 (226.5e9 against
      453.0e9 B). The recomputed forward still runs the second expert
      product, whose gather of w2 the memo keeps for the backward's
      ``g @ w2.T``: the combine's backward needs its output (the gradient
      of the routing weights), and the reference's backward body computes
      it too (``dot.605``, f32[40,49160,5120], beside the transposes),
      so the checkpoint's early stop, which ends the recompute after the
      last tensor the backward needs, cannot drop it; it does drop the
      shared experts' w2 product (its output only added). All-reduce, mixtral
      0.47-0.50 (measured 0.4874, 0.4836): bf16 against the reference's
      f32, the port's masked lookups all-reducing its (E*C, d) buffer and
      k (T, d) combine outputs where the reference all-reduces (T*k, d)
      slot rows; deepseek-v2-236b 0.28-0.31 (measured 0.2923): the
      reference all-reduces its (T*k, d) = (6,291,456, 5,120) f32 slot
      rows in the forward, the remat and the transposes, with a u32 twin
      of the forward's (15.46e12 B), against the port's bf16 (E*C, d) =
      (7,865,600, 5,120) dispatch and 6 (T, d) combine lookups. The
      reference's collective-permutes move the vocab padding and the
      FSDP shards of the embedding table and the router; the port's
      reduce-scatter (exact) puts the embedding table's gradient onto its
      FSDP shards (``shard_like``), where the reference's CPU compile
      all-reduces it (no reference HLO holds a reduce-scatter)."""
    mine, ref = fake_group_cells["cells"][cell], ref_model_cells[cell]
    rl, rrl = mine["roofline"], ref["roofline"]
    assert mine["dtensor_choices"] == {}
    f_lo, f_hi, of, b_lo, b_hi = BANDS.get(cell,
                                           (0.9, 1.1, "all", 0.5, 2.5))
    ref_flops = ref["flops_no_loop"] if of == "no_loop" else \
        rrl["flops_per_device"]
    assert f_lo < rl["flops_per_device"] / ref_flops < f_hi
    assert b_lo < rl["hbm_bytes_per_device"] / rrl["hbm_bytes_per_device"] \
        < b_hi
    assert rl["model_flops"] == rrl["model_flops"]
    got, want = mine["collectives"]["by_kind"], ref["by_kind"]
    expect = COLL[cell]
    assert set(want) | set(got) == set(expect)
    for kind, e in expect.items():
        if e == "reference only":
            assert kind not in got and want[kind] > 0
        elif isinstance(e, tuple) and e[0] == "port only":
            assert kind not in want and got[kind] == e[1]
        elif e == "equal":
            assert got[kind] == want[kind]
        elif isinstance(e, tuple) and e[0] == "plus":
            assert 0 <= got[kind] - want[kind] <= e[1]
        elif isinstance(e, tuple) and e[0] == "less":
            assert got[kind] == want[kind] - e[1]
        elif isinstance(e, tuple):
            assert e[0] < got[kind] / want[kind] < e[1], (kind, got, want)
        else:
            assert got[kind] == pytest.approx(want[kind] * e, abs=1)
        assert kind in got or e == "reference only"


@pytest.mark.parametrize("cell", HELD, ids=CELL_IDS)
def test_model_cell_pinned(cell, fake_group_cells):
    """Every collective of these cells is the dry-run's own (run
    ``strict``: DTensor chose none), so their counts are fixed whatever
    the torch version: collectives, FLOPs and HBM bytes equal
    ``chip_smoke.DRYRUN_PINNED``, which phase 3j holds on the card's
    machine too. A change here means a placement or the cost model
    changed."""
    r = fake_group_cells["cells"][cell_id(*cell)]
    coll, rl = r["collectives"], r["roofline"]
    assert (coll["by_kind"], coll["n_collective_ops"],
            rl["flops_per_device"], rl["hbm_bytes_per_device"]) == \
        _chip_smoke().DRYRUN_PINNED[cell]


def test_strict_refuses_dtensor_choice(fake_group_cells):
    """(16, 32) sharded (data, model) plus (32,) sharded on data: the
    broadcast puts the second operand's shards along the first's model-
    sharded columns, which no rule of the dry-run places, so DTensor
    would choose a redistribution itself. ``strict`` raises naming the
    op; the default records it in ``implicit`` (a cell's
    ``dtensor_choices``)."""
    assert fake_group_cells["strict"].startswith("DTensor chose a ")
    assert "aten.add" in fake_group_cells["strict"]
    assert fake_group_cells["lax"] and all(
        k.startswith("aten.add") for k in fake_group_cells["lax"])


def test_dryrun_rules(fake_group_cells):
    """The dry-run's own rules: a lookup in a table sharded by rows over
    model=4 looks the data-sharded ids up in each shard's rows and
    all-reduces the (16, 16) f32 output once (1,024 B); a cache write at
    one position of a position-sharded cache stays on the shards and
    moves nothing more."""
    r = fake_group_cells["rules"]
    assert r["lookup"]["local"] == [16, 16]
    assert r["lookup"]["pl"] == "(Shard(dim=0), Replicate())"
    assert r["lookup"]["coll"] == {"all-reduce": 1024.0}
    assert r["cache"]["coll"] == r["lookup"]["coll"]
    assert r["cache"]["pl"] == "(Shard(dim=0), Shard(dim=1))"


def test_dryrun_rule_sort(fake_group_cells):
    """A stable sort along the model-sharded dim of a (16, 32) f32 tensor
    on (2, 4): the dim gathered (the (8, 32) shard, 1,024 B), the data
    shards kept, values and indices placed alike."""
    r = fake_group_cells["rules"]["sort"]
    assert r["coll"] == {"all-gather": 1024.0}
    assert r["pl"] == "(Shard(dim=0), Replicate())"
    assert r["local"] == [8, 32]


def test_dryrun_rule_slice(fake_group_cells):
    """The first 16 of 64 data-sharded (64, 8) f32 rows: each data shard
    keeps its even share (8 rows) with no gather; the second shard's
    rows 8-15 lie on the first, so one collective-permute of the (8, 8)
    output shard (256 B) a device, as XLA moves them; the slice's
    backward puts the shares back the same way."""
    r = fake_group_cells["rules"]
    assert r["slice"]["coll"] == {"collective-permute": 256.0}
    assert r["slice"]["pl"] == "(Shard(dim=0), Replicate())"
    assert r["slice"]["local"] == [8, 8]
    assert r["slice_backward"]["coll"] == {"collective-permute": 256.0}
    assert r["slice_backward"]["pl"] == "(Shard(dim=0), Replicate())"
    assert r["slice_backward"]["local"] == [32, 8]


def test_dryrun_rule_scatter_plain_target(fake_group_cells):
    """A scatter along dim 1 into a plain (16, 8) zeros target (as a
    backward formula makes one: torch 2.11's sort backward did) by
    data-sharded indices and updates: the target counts as replicated and
    takes the updates' data shards, each device scattering into its
    (8, 8) rows with no collective."""
    assert fake_group_cells["rules"]["scatter"] == {
        "coll": {}, "local": [8, 8], "pl": "(Shard(dim=0), Replicate())"}


def test_dryrun_rule_lookups(fake_group_cells):
    """``gather`` along an unsharded dim with its index sharded as the
    values: each device on its rows, no collective; ``gather`` along the
    model-sharded dim of (4, 32) f32 with a replicated (4, 3) index: each
    device looks the index up in its own columns and the (4, 3) output
    is all-reduced (48 B); ``x[idx]`` of data-sharded (32,) int64 rows by
    a replicated index (MoE's ``flat_e[order]``): the same, 256 B; the
    diagonal of a row-sharded (16, 16): each device's own rows, sharded
    along the diagonal, no collective."""
    r = fake_group_cells["rules"]
    assert r["gather"] == {"coll": {}, "local": [8, 2],
                           "pl": "(Shard(dim=0), Replicate())"}
    assert r["gather_masked"] == {"coll": {"all-reduce": 48.0},
                                  "local": [4, 3],
                                  "pl": "(Replicate(), Replicate())"}
    assert r["index"] == {"coll": {"all-reduce": 256.0}, "local": [32],
                          "pl": "(Replicate(), Replicate())"}
    assert r["diagonal"] == {"coll": {}, "local": [8],
                             "pl": "(Shard(dim=0), Replicate())"}


def test_dryrun_rule_decode_contraction(fake_group_cells):
    """Decode over a position-sharded cache on (2, 4): the scores of
    (4, 8, 16) queries with their heads on model against a (4, 32, 16)
    cache with its positions on model gather the smaller operand, the
    queries (a (2, 8, 16) f32 output, 1,024 B), and keep the positions'
    shards; the values' contraction over the sharded positions is a
    partial sum on model, all-reduced where the einsum's next op (a
    permute) consumes it, as XLA reduces the product's output (the
    (2, 8, 16) f32 shard, 1,024 B), with no gather of the cache."""
    r = fake_group_cells["rules"]
    assert r["decode_scores"]["coll"] == {"all-gather": 1024.0}
    assert r["decode_scores"]["pl"] == "(Shard(dim=0), Shard(dim=2))"
    assert r["decode_scores"]["local"] == [2, 8, 8]
    assert r["decode_out"]["coll"] == {"all-gather": 1024.0,
                                       "all-reduce": 1024.0}
    assert r["decode_out"]["pl"] == "(Shard(dim=0), Replicate())"
    assert r["decode_out"]["local"] == [2, 8, 16]


def test_dryrun_rule_gqa_view(fake_group_cells):
    """32 query heads on model=16, viewed as 8 KV groups of 4: with the
    axis factored (8, 2), the view shards the groups on "model" and the
    queries within a group on "model.1" (each device one group's 2
    queries), the scores against replicated KV groups keep both, and the
    merge back gives 2 heads a device: no collective at all.
    ``model_axis_factors`` factors model=16 for minitron-8b's and
    mixtral-8x7b's 8 KV heads, and neither model=4 nor deepseek-7b's 32
    KV heads."""
    r = fake_group_cells["rules"]
    assert r["gqa_view"] == {"coll": {}, "local": [1, 4, 1, 2, 8],
                             "pl": "(Shard(dim=0), Shard(dim=2), "
                                   "Shard(dim=3))"}
    assert r["gqa_scores"] == {"coll": {}, "local": [1, 4, 1, 2, 6],
                               "pl": r["gqa_view"]["pl"]}
    assert r["gqa_merge"] == {"coll": {}, "local": [1, 4, 2, 8],
                              "pl": "(Shard(dim=0), Shard(dim=2), "
                                    "Shard(dim=2))"}
    assert fake_group_cells["factors"] == [[8, 2], None, None, [8, 2]]


def test_dryrun_rule_uneven_hint(fake_group_cells, ref_model_cells):
    """A hint whose axis does not divide the dim shards it as XLA pads it:
    (10, 16) f32 hinted to ("data", None) on a (4, 2) mesh is a
    (3, 16) shard a device (ceil(10 / 4) rows, the reference's
    ``f32[3,16]``), gathered back by a padded all-gather of (12, 16)
    (768 B, sliced to 10 rows after). A partial sum (a product whose
    contraction is data-sharded) hinted so is all-reduced whole (640 B of
    output, 1,280 moved), then sliced, as XLA reduces into an uneven shard
    (no reduce-scatter). The local shapes and the bytes moved by kind
    equal the reference's compiled HLO on 8 forced host devices."""
    mine = fake_group_cells["rules"]
    ref = ref_model_cells["rules"]
    assert ref["uneven_hint"] == {"local": [3, 16],
                                  "coll": {"all-gather": 768.0}}
    assert ref["uneven_reduce"]["coll"] == {"all-reduce": 1280.0,
                                            "all-gather": 768.0}
    for name in ("uneven_hint", "uneven_reduce"):
        assert mine[name]["local"] == ref[name]["local"] == [3, 16]
        assert mine[name]["pl"] == "(Shard(dim=0), Replicate())"
        assert mine[name]["coll"] == ref[name]["coll"]
        assert mine[name]["out"] == [[10, 16], [10, 16]]


def test_dryrun_rule_recompute_gather(fake_group_cells, ref_model_cells):
    """Two checkpointed layers ``tanh(h @ w)`` over (16, 16) f32 weights
    sharded FSDP-style (the contraction over data) on a (2, 4) mesh, with
    data-sharded (64, 16) rows: the forward gathers each weight once, and
    the recompute gathers it once more for both the recomputed product
    and the backward's (``ShardedCost.recompute``'s memo; without it the
    backward gathered again): 4 all-gathers of 1,024 B, as the
    reference's ``jax.checkpoint`` (``nothing_saveable``) over
    ``lax.scan`` gathers each weight once in its forward loop body and
    once in its backward loop body (its HLO, 8 forced host devices,
    trip counts multiplied)."""
    mine = fake_group_cells["rules"]["recompute_gather"]
    ref = ref_model_cells["rules"]["recompute_gather"]
    assert ref == {"n": 4, "bytes": 4096.0}
    assert mine == ref


def test_dryrun_rule_inbatch_split(fake_group_cells, ref_model_cells):
    """The two-tower's in-batch logits at (256, 32) f32 on (2, 4): towers
    ``tanh(x @ w)`` over a replicated (32, 32) ``w``, ``u @ v.T`` hinted
    to (data, None), the diagonal's log-softmax. Items hinted as the
    model hints them (their rows onto model, then gathered): a
    collective-permute (8,192 B) moves each device's quarter of the rows
    onto model, an all-gather (32,768 B) gathers them, and the gradient's
    rows move back to their data shards (16,384 B): both equal the
    reference's HLO (no hint on its items: XLA's own choice). The
    backward products split as XLA's: ``g @ v`` along the items' model
    shards, the partial (128, 32) all-reduced over model; ``u.T @ g``
    computes only the device's own 64 item rows (its model shard), where
    the reference computes its data shard's 128 and permutes them; so
    the port's dot FLOPs are the reference's less 2 x 64 x 128 x 32, and
    its all-reduce the reference's less those rows' 2 x 64 x 32 x 4 B
    plus 8 B (the loss's f32 mean, a scalar the reference does not
    reduce). Items replicated all along are not split: dot FLOPs equal
    the reference's, which computes them whole too (the rule is for a
    hint's gathered operand only; a general split fired in dlrm-rm2,
    where XLA does not split)."""
    mine, ref = fake_group_cells["rules"], ref_model_cells["rules"]
    split, rsplit = mine["inbatch_split"], ref["inbatch_split"]
    assert rsplit["coll"] == {"collective-permute": 24576.0,
                              "all-gather": 32768.0, "all-reduce": 65536.0}
    for kind in ("collective-permute", "all-gather"):
        assert split["coll"][kind] == rsplit["coll"][kind]
    rows = 2 * 64 * 32 * 4
    assert split["coll"]["all-reduce"] == rsplit["coll"]["all-reduce"] \
        - rows + 8
    assert split["dot_flops"] == rsplit["dot_flops"] - 2 * 64 * 128 * 32
    whole, rwhole = mine["inbatch_replicated"], ref["inbatch_replicated"]
    assert whole["dot_flops"] == rwhole["dot_flops"] == 7864320.0
    assert set(whole["coll"]) == set(rwhole["coll"]) == {"all-reduce"}
    assert whole["coll"]["all-reduce"] == rwhole["coll"]["all-reduce"] + 8


def test_host_mesh_cell(fake_group_cells):
    """One device: nothing to communicate; the model FLOPs and the JSON
    keys the reference writes."""
    r = fake_group_cells["host"]
    assert r["status"] == "ok", r.get("traceback")
    rl = r["roofline"]
    assert rl["n_devices"] == 1 and rl["collective_bytes_per_device"] == 0
    assert rl["model_flops"] == r["meta"]["model_flops_per_step"] > 0
    assert 0 < rl["useful_flops_ratio"] <= 1.5
    assert {"roofline", "collectives", "memory", "meta", "status",
            "compile_s", "dtensor_choices"} <= set(r)
    assert r["hw"]["collective_bw"] == 450e9


# ----------------------------------------------------------- ranking cells
RANK_SHAPES = {"tiny": {"kind": "rank", "n_nodes": 4096, "n_edges": 32768,
                        "n_vectors": 1, "dangling_frac": 0.5},
               "tiny_multi": {"kind": "rank", "n_nodes": 4096,
                              "n_edges": 32768, "n_vectors": 4,
                              "dangling_frac": 0.5}}
RANK_MODES = ("baseline", "dual_blocked", "dual_blocked+compact+bf16")
# the reference's dual_blocked sweep cannot run with V > 1 (it multiplies
# the gathered (E, V) rows by (E,) weights without a new axis: a
# broadcasting error), so its multi-vector cells are port-only
REF_CELLS = [("tiny", m) for m in RANK_MODES] + [("tiny_multi", "baseline")]

REF_RANK = r"""
import os, json, dataclasses, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro.compat import make_mesh, set_mesh
from repro.configs import get_spec
from repro.launch import hlo_analysis
from repro.launch.dryrun import _to_named
from repro.launch.steps import build_step
from repro.sparse.dist import make_dryrun_rank_sweep
shapes, cells = json.loads(sys.argv[1]), json.loads(sys.argv[2])
spec = dataclasses.replace(get_spec("hits-webgraph"), shapes=shapes)
mesh = make_mesh((2, 4), ("data", "model"))
out = {}
for shape, mode in cells:
    step = build_step(spec, shape, n_devices=8, mode=mode)
    shp = shapes[shape]
    n_hub = int(shp["n_nodes"] * (1 - shp["dangling_frac"]))
    fn = make_dryrun_rank_sweep(mesh, shp["n_nodes"], axes=mesh.axis_names,
                                mode=mode, n_hub=n_hub)
    with set_mesh(mesh):
        comp = jax.jit(fn, in_shardings=_to_named(
            step.in_specs, mesh, step.args)).lower(*step.args).compile()
    out[shape + "/" + mode] = hlo_analysis.collective_bytes(
        comp.as_text())["by_kind"]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_rank_bytes(subprocs):
    return _last_json(subprocs["ref_rank"])


def port_rank_cell(shape, mode):
    spec = dataclasses.replace(PREG["hits-webgraph"], shapes=RANK_SHAPES)
    mesh = Mesh(("meta",) * 8, (2, 4), ("data", "model"))
    step, out = dryrun.rank_cell(spec, shape, mesh, mode, "h100-sxm")
    rl = out["roofline"]
    got = out["collectives"]["output_bytes_by_kind"]
    assert rl["collective_bytes_per_device"] == sum(
        b * (2 if k == "all-reduce" else 1) for k, b in got.items())
    assert rl["flops_per_device"] > 0 and rl["hbm_bytes_per_device"] > 0
    assert rl["model_flops"] == step.meta["model_flops_per_step"]
    assert out["memory"]["argument_bytes"] > 0
    return got


@pytest.mark.parametrize("shape,mode", REF_CELLS)
def test_rank_cell_collectives(ref_rank_bytes, shape, mode):
    """Per-device collective output bytes by kind: half the reference's
    ``hlo_analysis.collective_bytes`` reading on a (2, 4) mesh of forced
    host devices, which counts the entry computation twice
    (``_split_computations`` files its lines under its name and under
    ``__entry__``; ROADMAP Queue 3), while the port's mesh counts each
    collective once. Under ``+bf16`` the all-gathers are a quarter: the
    reference's HLO on the CPU gathers in f32 (its optimization barrier
    does not keep the convert after the collective there), the port's
    in bf16. The roofline prices moved bytes (an all-reduce twice its
    output, the reference's ``HloModule`` model)."""
    got = port_rank_cell(shape, mode)
    want = ref_rank_bytes[f"{shape}/{mode}"]
    assert set(got) == set(want)
    for kind in want:
        share = 4 if ("bf16" in mode and kind == "all-gather") else 2
        assert got[kind] == want[kind] / share, (kind, got, want)


@pytest.mark.parametrize("mode", RANK_MODES[1:])
def test_rank_cell_multi_vector_blocked(mode):
    """The port's dual_blocked sweep with V = 4 (the reference's cannot
    broadcast there): two all-gathers of the (n, V) and (n_hub, V)
    vectors, one all-reduce of an f32 scalar."""
    shp = RANK_SHAPES["tiny_multi"]
    n, v = shp["n_nodes"], shp["n_vectors"]
    n_h = int(n * (1 - shp["dangling_frac"])) if "compact" in mode else n
    item = 2 if "bf16" in mode else 4
    got = port_rank_cell("tiny_multi", mode)
    assert got == {"all-gather": float((n + n_h) * v * item),
                   "all-reduce": 4.0}


# ------------------------------------------------- JSONs, report and cache
def _roofline_report():
    spec = importlib.util.spec_from_file_location(
        "roofline_report", ROOT / "benchmarks" / "roofline_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_roofline_report_reads_port_json(tmp_path, monkeypatch):
    """An ``ok``, a ``skipped`` and an ``error`` cell written by
    ``run_cell``; the reference's report loads and tabulates them. The
    cache rule: ``ok``/``skipped`` are reused, an error is retried."""
    d = str(tmp_path)
    ok = dryrun.run_cell("hits-webgraph", "webrank_200m", "pod1", d,
                         mode="dual_blocked")
    skipped = dryrun.run_cell("deepseek-7b", "long_500k", "pod1", d)

    def broken(*a, **k):
        raise RuntimeError("no step")
    monkeypatch.setattr(dryrun, "build_step", broken)
    err = dryrun.run_cell("bst", "serve_p99", "pod1", d)
    assert (ok["status"], skipped["status"], err["status"]) == \
        ("ok", "skipped", "error")
    assert "no step" in err["error"] and "Traceback" in err["traceback"]
    # cached: an ok cell is not recomputed (build_step raises now)
    assert dryrun.run_cell("hits-webgraph", "webrank_200m", "pod1", d,
                           mode="dual_blocked") == ok
    monkeypatch.undo()
    monkeypatch.setattr(dryrun, "model_cell", lambda *a, **k: {
        "roofline": {}, "collectives": {}, "memory": {}})
    assert dryrun.run_cell("bst", "serve_p99", "pod1", d)["status"] == "ok"
    rr = _roofline_report()
    cells = [c for c in rr.load_cells(d, "pod1")
             if c["arch"] != "bst"]
    table = rr.report(cells)
    assert "hits-webgraph" in table and "skipped" in table
    assert "webrank_200m" in table and "deepseek-7b" in table
    assert ok["roofline"]["bottleneck"] in table
    for name in os.listdir(d):
        with open(os.path.join(d, name)) as f:
            assert json.load(f)["mesh"] == "pod1"


def test_main_flags(tmp_path, capsys):
    dryrun.main(["--arch", "hits-webgraph", "--shape", "webrank_multi",
                 "--mesh", "pod2", "--mode", "dual_blocked", "--hw",
                 "tpu-v5e", "--out", str(tmp_path)])
    line = capsys.readouterr().out
    assert line.startswith("[ok     ] hits-webgraph") and "pod2" in line
    r = json.loads((tmp_path / "hits-webgraph__webrank_multi__pod2__"
                    "dual_blocked.json").read_text())
    assert r["hw"]["name"] == "TPU v5e" and \
        r["hw"]["collective_bw"] == 50e9
    assert r["roofline"]["n_devices"] == 512


# ------------------------------------------- GIN's aggregation on meta edges
def _gin_batch(kind, rng):
    n, e = 40, 160
    if kind == "node":
        return {"src": torch.from_numpy(rng.integers(0, n, e)).int(),
                "dst": torch.from_numpy(np.r_[rng.integers(0, n, e - 4),
                                              [n] * 4]).int()}, n
    g, nn, ne = (4, 10, 24) if kind == "graph" else (4, 12, 30)
    return {"src": torch.from_numpy(rng.integers(0, nn, (g, ne))).int(),
            "dst": torch.from_numpy(rng.integers(0, nn + 1, (g, ne))).int()
            }, nn


@pytest.mark.parametrize("kind", ["node", "graph", "batched"])
@pytest.mark.parametrize("tile_e", [8, 256])
def test_edge_layout_bound(kind, tile_e):
    """K3's layouts of ``meta`` edges (the dry-run's) have the real
    layouts' structure and at least their slots: every block padded to
    whole tiles, one at least, so n_tiles <= n_blocks + ceil(E/tile_e),
    on a graph's edges (4 out of range), G graphs' and sampled groups'."""
    edges, n = _gin_batch(kind, np.random.default_rng(7))
    real = pg.EdgeLayouts.build(edges["src"], edges["dst"], n, bs=8,
                                tile_e=tile_e)
    bound = pg.EdgeLayouts.build(edges["src"].to("meta"),
                                 edges["dst"].to("meta"), n, bs=8,
                                 tile_e=tile_e)
    assert bound.n_nodes == real.n_nodes and bound.scratch is None
    for r, b in ((real.fwd, bound.fwd), (real.rev, bound.rev)):
        assert (b.n_blocks, b.n_out, b.bs) == (r.n_blocks, r.n_out, r.bs)
        assert b.tile_ptr.shape == r.tile_ptr.shape
        assert b.blkid.shape[0] >= r.blkid.shape[0]
        assert b.blkid.shape[0] == b.n_blocks + -(-edges["src"].numel()
                                                  // tile_e)
        for f in ("rows", "edge", "off", "valid"):
            t, m = getattr(r, f), getattr(b, f)
            assert m.device.type == "meta" and m.dtype == t.dtype
            assert m.shape[0] == b.blkid.shape[0] * tile_e >= t.shape[0]


def test_k3_counts_its_traffic_on_meta():
    """``aggregate`` on ``meta`` tensors under ``StepCost``: the gather
    of h's rows into the slots (twice its output, the reference's rule
    for a gather), the weights gathered to the slots and multiplied in,
    and K3, which reads its operands once, writes its output once and
    its workspace out and back, and adds each message element once."""
    n, e, f, tile_e = 1000, 5000, 16, 256
    src = torch.empty(e, dtype=torch.int32, device="meta")
    lay = pg.EdgeLayouts.build(src, src, n, tile_e=tile_e)
    h = torch.empty(n, f, device="meta")
    w = torch.empty(e, device="meta")
    with StepCost() as cost:
        out = pg.aggregate(h, lay, w)
    assert out.shape == (n, f) and out.device.type == "meta"
    fw = lay.fwd
    e_pad, n_tiles, nb = fw.rows.shape[0], fw.blkid.shape[0], fw.n_blocks
    assert (nb, n_tiles, e_pad) == (8, 8 + 20, 28 * tile_e)
    msgs = e_pad * f * 4
    gather = 2 * msgs                                   # h's rows
    weights = 2 * e_pad * 4 + (2 * msgs + e_pad * 4)    # w[edge], mul_
    k3 = (n_tiles * 4 + msgs + 2 * e_pad * 4 + (nb + 1) * 4   # reads
          + nb * fw.bs * f * 4                          # output
          + 2 * n_tiles * fw.bs * f * 4)                # workspace
    assert cost.bytes == gather + weights + k3
    assert cost.flops == 2 * e_pad * f                  # mul_ and K3
