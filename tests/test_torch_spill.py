"""The port's checkpoint (``repro_torch.checkpoint``) and restart spill
(``serve/spill.py``: ``CacheSpill``, ``PlanSpill`` and the service's spill
half) on the CPU, mirroring ``tests/test_checkpoint_ft.py`` and
``tests/test_serve_spill.py``, plus cross-package cases in both
directions: a checkpoint or spill directory the JAX package writes
restores in the port and one the port writes restores in the JAX package,
with the same ``arrays.npz`` keys (in the same order) and bit-equal
served vectors. bfloat16 plans persist as the 2-byte patterns the JAX
package writes (``runtime.host_array``).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as rck
from repro.graph import WebGraphSpec, generate_webgraph
from repro.serve import RankService as RefService
from repro.serve import RankServiceConfig as RefConfig
from repro.serve import backends as rb
from repro.serve import spill as rspill
from repro_torch import checkpoint as ck
from repro_torch.checkpoint import latest_step, restore_arrays
from repro_torch.graph import from_reference, root_set_key
from repro_torch.runtime import from_host, host_array
from repro_torch.serve import (CacheSpill, PipelineJob, PlanSpill,
                               RankService, RankServiceConfig)
from repro_torch.serve import backends as pb

TOL = 1e-12
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rg():
    return generate_webgraph(WebGraphSpec(1500, 12000, 0.5, seed=8))


@pytest.fixture(scope="module")
def g(rg):
    return from_reference(rg)


@pytest.fixture(scope="module")
def queries(rg):
    rng = np.random.default_rng(2)
    return [rng.choice(rg.n_nodes, size=4, replace=False) for _ in range(6)]


def svc_for(g, spill_dir, **kw):
    kw.setdefault("v_max", 4)
    kw.setdefault("tol", TOL)
    return RankService(g, RankServiceConfig(device="cpu",
                                            spill_dir=str(spill_dir), **kw))


def ref_for(rg, spill_dir, **kw):
    kw.setdefault("v_max", 4)
    kw.setdefault("tol", TOL)
    if spill_dir is not None:
        kw["spill_dir"] = str(spill_dir)
    return RefService(rg, RefConfig(**kw))


# ------------------------------------------------------------ checkpoint

def tree_np():
    """A tree with every container the flattener walks, in insertion
    order that is not sorted (JAX sorts dict keys)."""
    rng = np.random.default_rng(0)
    return {"zeta": rng.random((3, 2)),
            "alpha": [np.arange(4, dtype=np.int32), None,
                      (np.float32(1.5), rng.random(2))],
            "mid": (np.ones(2), {"b": np.zeros(1), "a": np.int64(7)})}


def test_checkpoint_roundtrip(tmp_path):
    tree = tree_np()
    ck.save(str(tmp_path), 7, tree, extra={"note": "x"})
    back, step, extra = ck.restore(str(tmp_path), tree)
    assert step == 7 and extra["note"] == "x"
    assert list(back) == sorted(tree)
    assert back["alpha"][1] is None and isinstance(back["mid"], tuple)
    flat_a, flat_b = ck.checkpoint._flatten(back), ck.checkpoint._flatten(tree)
    assert list(flat_a) == list(flat_b)
    for k in flat_a:
        assert flat_a[k].dtype == flat_b[k].dtype
        assert np.array_equal(flat_a[k], flat_b[k]), k


def test_bf16_leaves_round_trip_as_patterns(tmp_path):
    """A bf16 tensor checkpoints as its 2-byte patterns
    (``runtime.host_array``) and comes back bit for bit
    (``runtime.from_host``)."""
    t = torch.randn(5).to(torch.bfloat16)
    ck.save(str(tmp_path), 1, {"h": host_array(t), "w": np.ones(2)})
    arrays, _, _ = restore_arrays(str(tmp_path))
    assert arrays["k=h"].dtype == np.dtype("V2")
    back = from_host(arrays["k=h"])
    assert back.dtype == torch.bfloat16 and torch.equal(back, t)


def test_checkpoint_prune_and_latest(tmp_path):
    params = {"w": np.ones(3)}
    for s in (1, 2, 3, 4):
        ck.save(str(tmp_path), s, params)
    assert latest_step(str(tmp_path)) == 4
    ck.prune(str(tmp_path), keep=2)
    assert latest_step(str(tmp_path)) == 4
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2


def test_junk_step_dirs_read_as_absent(tmp_path):
    """A stray non-numeric ``step_*`` dir is skipped, never fatal, and
    never deleted."""
    params = {"w": np.ones(3)}
    for s in (1, 2):
        ck.save(str(tmp_path), s, params)
    os.makedirs(tmp_path / "step_backup")
    (tmp_path / "step_backup" / "manifest.json").write_text("{}")
    os.makedirs(tmp_path / "step_12.orig")
    assert latest_step(str(tmp_path)) == 2
    ck.prune(str(tmp_path), keep=1)
    assert latest_step(str(tmp_path)) == 2
    assert (tmp_path / "step_backup").is_dir()
    assert (tmp_path / "step_12.orig").is_dir()
    _, step, _ = ck.restore(str(tmp_path), params)
    assert step == 2
    with pytest.raises(FileNotFoundError):
        restore_arrays(str(tmp_path / "nothing"))
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(str(tmp_path), {"v": np.ones(3)})


def npz_layout(d):
    """(key, dtype string, bytes) of a checkpoint's arrays.npz, in file
    order."""
    step = latest_step(str(d))
    with np.load(os.path.join(str(d), f"step_{step:010d}",
                              "arrays.npz")) as z:
        return [(k, z[k].dtype.str, z[k].tobytes()) for k in z.files]


def as_jax(tree):
    if isinstance(tree, dict):
        return {k: as_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_jax(x) for x in tree)
    return None if tree is None else jnp.asarray(tree)


@pytest.mark.parametrize("writer", ["repro", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """The same tree saved by either package gives the same npz keys in
    the same order and the same bytes, and restores in the other package
    bit for bit (a bf16 leaf included: both write its 2-byte patterns,
    which the port reads back as a bf16 tensor)."""
    tree = tree_np()
    jtree = as_jax(tree)
    jtree["bf"] = jnp.asarray(np.linspace(-2, 2, 7), jnp.bfloat16)
    bf = torch.from_numpy(np.linspace(-2, 2, 7)).to(torch.bfloat16)
    ptree = dict(tree, bf=host_array(bf))
    (tmp_path / "r").mkdir()
    (tmp_path / "p").mkdir()
    rck.save(str(tmp_path / "r"), 3, jtree)
    ck.save(str(tmp_path / "p"), 3, ptree)
    assert npz_layout(tmp_path / "r") == npz_layout(tmp_path / "p")
    d = tmp_path / ("r" if writer == "repro" else "p")
    if writer == "repro":
        back, step, _ = ck.restore(str(d), ptree)
        assert torch.equal(from_host(back["bf"]), bf)
        got, want = ck.checkpoint._flatten(back), ck.checkpoint._flatten(ptree)
    else:
        jtree.pop("bf")  # the JAX package cannot cast 2-byte voids back
        back, step, _ = rck.restore(str(d), jtree)
        got = {k: np.asarray(v) for k, v in rck.checkpoint._flatten(back)
               .items()}
        want = rck.checkpoint._flatten(jtree)
    assert step == 3 and list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


# ------------------------------------------------------- CacheSpill store


def test_spill_round_trip_exact(tmp_path):
    sp = CacheSpill(str(tmp_path))
    key = root_set_key([5, 2, 9])
    nodes = np.array([2, 5, 9, 77], np.int32)
    auth = np.array([0.5, 0.25, 0.25, 0.0])
    hub = np.array([0.1, 0.2, 0.3, 0.4])
    sp.put(key, nodes, auth, hub)
    e = sp.get(key)
    assert np.array_equal(e["nodes"], nodes)
    assert e["nodes"].dtype == nodes.dtype
    assert np.array_equal(e["authority"], auth)
    assert np.array_equal(e["hub"], hub)
    assert key in sp and sp.keys() == [key] and len(sp) == 1
    assert sp.get("0" * 40) is None
    sp.put(key, nodes, auth * 2, hub)
    assert latest_step(os.path.join(str(tmp_path), key)) == 2
    assert np.array_equal(sp.get(key)["authority"], auth * 2)
    arrays, step, extra = restore_arrays(os.path.join(str(tmp_path), key))
    assert step == 2 and extra["key"] == key
    assert np.array_equal(arrays["k=nodes"], nodes)
    # the JAX package's store reads the port's record, and vice versa
    assert np.array_equal(rspill.CacheSpill(str(tmp_path)).get(key)
                          ["authority"], auth * 2)
    other = root_set_key([1])
    rspill.CacheSpill(str(tmp_path)).put(other, nodes, hub, auth)
    assert np.array_equal(sp.get(other)["hub"], auth)


def test_load_recent_orders_newest_first_and_limits(tmp_path):
    sp = CacheSpill(str(tmp_path))
    keys = [root_set_key([i]) for i in range(5)]
    for i, k in enumerate(keys):
        sp.put(k, np.array([i], np.int32), np.ones(1), np.ones(1))
        mdir = os.path.join(str(tmp_path), k, f"step_{1:010d}")
        with open(os.path.join(mdir, "manifest.json")) as f:
            m = json.load(f)
        m["time"] = float(i)
        with open(os.path.join(mdir, "manifest.json"), "w") as f:
            json.dump(m, f)
    got = list(sp.load_recent(limit=3))
    assert [k for k, _ in got] == keys[::-1][:3]


def test_foreign_junk_in_spill_dir_is_ignored(tmp_path, g):
    (tmp_path / "README.txt").write_text("not a cache entry")
    (tmp_path / "not-a-hash").mkdir()
    bad = root_set_key([1])
    (tmp_path / bad / "step_0000000001").mkdir(parents=True)
    (tmp_path / bad / "step_0000000001" / "manifest.json").write_text("{}")
    svc = svc_for(g, tmp_path)
    assert svc.stats["spill_restored"] == 0
    assert svc.rank([[1, 2, 3]])[0].status == "cold"


def test_junk_step_dir_inside_entry_does_not_brick_restart(tmp_path, g,
                                                           queries):
    svc1 = svc_for(g, tmp_path)
    cold = svc1.rank(queries[:2])
    del svc1
    key = cold[0].key
    (tmp_path / key / "step_backup").mkdir()
    (tmp_path / key / "step_backup" / "manifest.json").write_text("{}")
    sp = CacheSpill(str(tmp_path))
    assert key in sp and key in sp.keys()
    assert np.array_equal(sp.get(key)["authority"], cold[0].authority)
    svc2 = svc_for(g, tmp_path)
    assert svc2.stats["spill_restored"] == 2
    for c, a in zip(cold, svc2.rank(queries[:2])):
        assert a.status == "hit" and a.iters == 0
        assert np.array_equal(a.authority, c.authority)


def test_entries_from_wrong_graph_rejected(tmp_path, g):
    sp = CacheSpill(str(tmp_path))
    key = root_set_key([3])
    sp.put(key, np.array([g.n_nodes + 5], np.int32), np.ones(1), np.ones(1))
    svc = svc_for(g, tmp_path)
    assert svc.stats["spill_restored"] == 0
    assert svc._admit_spilled(key, svc._spill.get(key)) is None
    assert svc.stats["spill_hits"] == 0


# ---------------------------------------------- RankService spill behavior


def test_eviction_spills_and_disk_fallback_serves_hit(tmp_path, g, queries):
    svc = svc_for(g, tmp_path, cache_size=2, spill_policy="evict")
    cold = svc.rank(queries[:3])
    assert svc.stats["spill_writes"] == 1  # exactly the one evictee
    assert len(svc._cache) == 2
    r = svc.rank([queries[0]])[0]  # evicted from RAM, alive on disk
    assert r.status == "hit" and r.iters == 0
    assert svc.stats["spill_hits"] == 1
    assert np.array_equal(r.authority, cold[0].authority)
    assert np.array_equal(r.hub, cold[0].hub)
    snap = svc.telemetry_snapshot()
    assert snap["service.spill.read_ms"]["count"] >= 1
    # the disk hit's readmission evicted (and spilled) another entry
    assert snap["service.spill.write_ms"]["count"] == \
        svc.stats["spill_writes"] == 2


def test_policy_all_spills_every_converged_entry(tmp_path, g, queries):
    svc = svc_for(g, tmp_path, spill_policy="all")
    svc.rank(queries)
    assert svc.stats["spill_writes"] == len(queries)
    assert len(CacheSpill(str(tmp_path))) == len(queries)


def test_flush_spill_drains_ram_cache(tmp_path, g, queries):
    svc = svc_for(g, tmp_path, spill_policy="evict")
    svc.rank(queries[:3])
    assert len(CacheSpill(str(tmp_path))) == 0  # nothing evicted yet
    svc.flush_spill()
    assert len(CacheSpill(str(tmp_path))) == 3
    no_spill = RankService(g, RankServiceConfig(device="cpu", v_max=4,
                                                tol=TOL))
    with pytest.raises(ValueError):
        no_spill.flush_spill()
    assert no_spill.gc_spill() == 0


def test_bad_spill_policy_rejected(tmp_path, g):
    with pytest.raises(ValueError):
        svc_for(g, tmp_path, spill_policy="sometimes")


def test_restart_same_process_restores_cache_and_warm_table(tmp_path, g,
                                                            queries):
    svc1 = svc_for(g, tmp_path)
    cold = svc1.rank(queries)
    del svc1
    svc2 = svc_for(g, tmp_path)
    assert svc2.stats["spill_restored"] == len(queries)
    for c, a in zip(cold, svc2.rank(queries)):
        assert a.status == "hit" and a.iters == 0
        assert np.array_equal(a.authority, c.authority)
    overlap = queries[0][:-1]  # new key, mostly-seen base set
    r = svc2.rank([overlap])[0]
    assert r.key != root_set_key(queries[0])
    assert r.status == "warm"


# ------------------------------------------------------------ plan spill


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_plan_spill_restart_skips_layout_rebuild(tmp_path, g, queries,
                                                 backend):
    """A fresh service on the same spill dir re-sweeps (refresh) through
    disk-restored plans: no layout rebuilt, and the same bits as the
    service that built them."""
    kw = dict(backend=backend, bsr_block=64)
    svc1 = svc_for(g, tmp_path, **kw)
    first = svc1.rank(queries, refresh=True)
    assert svc1.stats["plan_spilled"] == svc1.stats["plan_misses"] >= 1
    del svc1
    svc2 = svc_for(g, tmp_path, **kw)
    svc2.clear_result_cache()  # vectors gone, plans kept on disk
    res = svc2.rank(queries)
    assert svc2.stats["plan_restored"] >= 1, svc2.stats
    assert svc2.stats["plan_misses"] == 0, svc2.stats
    for a, b in zip(res, first):
        assert a.status == b.status == "cold" and a.iters == b.iters
        assert np.array_equal(a.authority, b.authority)
        assert np.array_equal(a.hub, b.hub)
    svc2.rank(queries, refresh=True)
    assert svc2.stats["plan_hits"] >= 1


def test_corrupt_plan_spill_rebuilds_instead_of_crashing(tmp_path, g,
                                                         queries):
    svc1 = svc_for(g, tmp_path)
    svc1.rank(queries[:2])
    plans_dir = os.path.join(str(tmp_path), "plans")
    names = os.listdir(plans_dir)
    assert names
    payloads = [b"not an npz", b"PK\x03\x04truncated-zip-header"]
    for i, name in enumerate(names):
        step = sorted(os.listdir(os.path.join(plans_dir, name)))[-1]
        with open(os.path.join(plans_dir, name, step, "arrays.npz"),
                  "wb") as f:
            f.write(payloads[i % len(payloads)])
    svc2 = svc_for(g, tmp_path)
    res = svc2.rank(queries[:2], refresh=True)
    assert svc2.stats["plan_restored"] == 0
    assert svc2.stats["plan_misses"] >= 1
    assert all(r.status in ("warm", "cold") for r in res)


def test_plan_spill_key_mismatch_rejected(tmp_path):
    ps = PlanSpill(str(tmp_path))
    key = ("dense", (), "a" * 40)
    ps.put(key, {"src": np.arange(4, dtype=np.int32)}, {"n_pad": 8})
    arrays, meta = ps.get(key)
    assert np.array_equal(arrays["src"], np.arange(4)) and meta["n_pad"] == 8
    assert key in ps and len(ps) == 1
    assert ps.get(("dense", (), "b" * 40)) is None
    other = ("bsr", (128,), "c" * 40)
    ps.put(other, {"x": np.zeros(1)}, {})
    entry_dir = os.path.join(str(tmp_path), "plans", ps._name(other))
    step = sorted(os.listdir(entry_dir))[-1]
    man = os.path.join(entry_dir, step, "manifest.json")
    with open(man) as f:
        m = json.load(f)
    m["extra"]["cache_key"] = repr(("tampered",))
    with open(man, "w") as f:
        json.dump(m, f)
    assert ps.get(other) is None


# ------------------------------------------------ bf16 plans in the spill


def bf16_batch(svc):
    return svc.pipeline.assemble(PipelineJob(queries=[
        svc.validate_roots(q) for q in ([1, 2, 3], [40, 41])])).batch


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_bf16_plan_round_trips(tmp_path, g, backend):
    """A bf16 plan persists as 2-byte patterns (what the JAX package
    writes for a bf16 array) and restores to the same bits."""
    svc = RankService(g, RankServiceConfig(device="cpu", dtype="bfloat16",
                                           backend=backend, bsr_block=32))
    b = bf16_batch(svc)
    be = pb.make_backend(backend, bsr_block=32, device="cpu")
    plan = be.plan(b)
    arrays, meta = be.plan_arrays(plan)
    blocks = "w" if backend == "dense" else "lt_blocks"
    assert arrays[blocks].dtype == np.dtype("V2")
    ps = PlanSpill(str(tmp_path))
    ps.put(("k",), arrays, meta)
    back = be.plan_restore(plan.key, *ps.get(("k",)))
    if backend == "dense":
        assert back.edges.w.dtype == torch.bfloat16
        assert torch.equal(back.edges.w, plan.edges.w)
    else:
        for op in ("lt", "lfwd"):
            assert torch.equal(getattr(back, op).blocks,
                               getattr(plan, op).blocks)
    for x, y in zip(be.sweep(back, b), be.sweep(plan, b)):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_reference_bf16_plan_restores_into_the_port(tmp_path, rg, g,
                                                    backend):
    """A bf16 plan the JAX package spilled restores into the port with the
    blocks of the port's own plan for the same batch, bit for bit."""
    svc = RankService(g, RankServiceConfig(device="cpu", dtype="bfloat16",
                                           backend=backend, bsr_block=32))
    b = bf16_batch(svc)
    rsvc = ref_for(rg, None, dtype=jnp.bfloat16, backend=backend,
                   bsr_block=32)
    rbatch = rsvc.pipeline.assemble(rsvc_job(rsvc)).batch
    rbe = (rb.DenseSweepBackend() if backend == "dense"
           else rb.BsrSweepBackend(bs=32, interpret=True))
    rspill.PlanSpill(str(tmp_path)).put(("k",),
                                        *rbe.plan_arrays(rbe.plan(rbatch)))
    be = pb.make_backend(backend, bsr_block=32, device="cpu")
    back = be.plan_restore("k", *PlanSpill(str(tmp_path)).get(("k",)))
    own = be.plan(b)
    if backend == "dense":
        assert torch.equal(back.edges.w, own.edges.w)
        assert torch.equal(back.edges.src, own.edges.src)
    else:
        for op in ("lt", "lfwd"):
            assert torch.equal(getattr(back, op).blocks,
                               getattr(own, op).blocks)
            assert torch.equal(getattr(back, op).idx, getattr(own, op).idx)


def rsvc_job(rsvc):
    from repro.serve import PipelineJob as RefJob
    return RefJob(queries=[rsvc.validate_roots(q)
                           for q in ([1, 2, 3], [40, 41])])


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_bf16_service_restarts_from_its_spill(tmp_path, g, backend):
    """A bf16 service spills its plans and vectors; a restart serves the
    vectors as hits, and after clearing them re-sweeps through restored
    plans to the first service's bits."""
    kw = dict(dtype="bfloat16", backend=backend, bsr_block=32)
    qs = [[1, 2, 3], [40, 41], [7, 9]]
    a = svc_for(g, tmp_path, **kw)
    first = a.rank(qs)
    assert a.stats["plan_spilled"] >= 1
    b = svc_for(g, tmp_path, **kw)
    assert b.stats["spill_restored"] == len(qs)
    assert all(r.status == "hit" for r in b.rank(qs))
    b.clear_result_cache()
    again = b.rank(qs)
    assert b.stats["plan_restored"] >= 1 and b.stats["plan_misses"] == 0
    for x, y in zip(again, first):
        assert np.array_equal(x.authority, y.authority)
        assert np.array_equal(x.hub, y.hub) and x.iters == y.iters


# ------------------------------------------ spill directories across packages


@pytest.mark.parametrize("backend", ["dense", "bsr"])
@pytest.mark.parametrize("writer", ["repro", "port"])
def test_spill_dir_crosses_packages(tmp_path, rg, g, queries, backend,
                                    writer):
    """A spill directory one package wrote serves in the other: every
    entry restores, the repeat stream is all hits with the writer's
    vectors bit for bit, and after clearing the vectors the reader
    re-sweeps through the writer's plans (no layout rebuilt) to within
    1e-10 L1 of the writer's answers."""
    kw = dict(backend=backend, bsr_block=64)
    if writer == "repro":
        w = ref_for(rg, tmp_path, **kw)
        r = lambda: svc_for(g, tmp_path, **kw)  # noqa: E731
    else:
        w = svc_for(g, tmp_path, **kw)
        r = lambda: ref_for(rg, tmp_path, **kw)  # noqa: E731
    cold = w.rank(queries)
    assert w.stats["spill_writes"] == len(queries)
    reader = r()
    assert reader.stats["spill_restored"] == len(queries)
    for c, h in zip(cold, reader.rank(queries)):
        assert h.status == "hit" and h.key == c.key
        assert np.array_equal(np.asarray(h.authority), c.authority)
        assert np.array_equal(np.asarray(h.hub), c.hub)
    reader.clear_result_cache()
    swept = reader.rank(queries)
    assert reader.stats["plan_restored"] >= 1, reader.stats
    assert reader.stats["plan_misses"] == 0, reader.stats
    for c, s in zip(cold, swept):
        assert s.status == "cold" and s.iters == c.iters
        assert np.abs(np.asarray(s.authority) - c.authority).sum() <= 1e-10
        assert np.abs(np.asarray(s.hub) - c.hub).sum() <= 1e-10


# --------------------------------------------- restart across processes


_PHASE = r"""
import sys
import numpy as np
from repro_torch.graph import WebGraphSpec, generate_webgraph
from repro_torch.serve import RankService, RankServiceConfig

SPILL, BACKEND, PHASE = sys.argv[1], sys.argv[2], sys.argv[3]
g = generate_webgraph(WebGraphSpec(260, 2000, 0.5, seed=2))
rng = np.random.default_rng(0)
queries = [rng.choice(g.n_nodes, size=4, replace=False) for _ in range(4)]
svc = RankService(g, RankServiceConfig(
    device="cpu", v_max=4, tol=1e-12, backend=BACKEND, bsr_block=64,
    spill_dir=SPILL))
if PHASE == "A":
    cold = svc.rank(queries)
    assert all(r.status == "cold" for r in cold)
    np.save(SPILL + "/iters.npy", np.array([r.iters for r in cold]))
    np.save(SPILL + "/auth0.npy", cold[0].authority)
else:
    cold_iters = np.load(SPILL + "/iters.npy")
    assert svc.stats["spill_restored"] == len(queries)
    r = svc.rank([queries[0]])[0]
    assert r.status == "hit" and r.iters == 0
    assert np.array_equal(r.authority, np.load(SPILL + "/auth0.npy"))
    # the same batch again: its union's plan comes off the disk
    w = svc.rank(queries, refresh=True)
    assert all(x.status == "warm" for x in w)
    assert all(x.iters <= c for x, c in zip(w, cold_iters))
    assert svc.stats["plan_restored"] == 1 and svc.stats["plan_misses"] == 0
    o = svc.rank([queries[2][:-1]])[0]
    assert o.status == "warm", o.status
print("PHASE", PHASE, "OK")
"""


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_restart_across_processes(tmp_path, backend):
    """Process A converges and spills; a separate process B on the spill
    dir serves the same root sets as hits, warm-starts a refresh of the
    batch through its restored plan, and warm-starts an overlapping root
    set."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    for phase in ("A", "B"):
        r = subprocess.run([sys.executable, "-c", _PHASE, str(tmp_path),
                            backend, phase], capture_output=True, text=True,
                           env=env, cwd=ROOT, timeout=600)
        assert r.returncode == 0, (r.stdout[-1000:], r.stderr[-3000:])
        assert f"PHASE {phase} OK" in r.stdout


# ------------------------------------------------------- generation GC


def _gens(entry_dir):
    return sorted(n for n in os.listdir(entry_dir) if n.startswith("step_"))


def test_gc_prunes_stale_generations_keeps_newest(tmp_path):
    sp = CacheSpill(str(tmp_path), keep_generations=3)
    key = root_set_key([4, 8, 15])
    nodes = np.array([4, 8, 15], np.int32)
    for i in range(1, 4):
        sp.put(key, nodes, np.full(3, float(i)), np.full(3, float(i)))
    entry = os.path.join(str(tmp_path), key)
    assert len(_gens(entry)) == 3
    assert sp.gc(keep=1) == 2
    assert _gens(entry) == ["step_0000000003"]
    assert np.array_equal(sp.get(key)["authority"], np.full(3, 3.0))
    assert sp.gc(keep=1) == 0


def test_put_prunes_inline_to_keep_generations(tmp_path):
    sp = CacheSpill(str(tmp_path), keep_generations=2)
    key = root_set_key([1, 2])
    nodes = np.array([1, 2], np.int32)
    for i in range(5):
        sp.put(key, nodes, np.zeros(2) + i, np.zeros(2))
    assert len(_gens(os.path.join(str(tmp_path), key))) == 2


def test_gc_sweeps_tmp_droppings_preserves_foreign(tmp_path):
    sp = CacheSpill(str(tmp_path))
    key = root_set_key([7, 9])
    sp.put(key, np.array([7, 9], np.int32), np.ones(2), np.ones(2))
    entry = os.path.join(str(tmp_path), key)
    os.makedirs(os.path.join(str(tmp_path), ".tmp_dead"))
    os.makedirs(os.path.join(entry, ".tmp_dead2"))
    os.makedirs(os.path.join(entry, "step_backup"))
    with open(os.path.join(str(tmp_path), "notes.txt"), "w") as f:
        f.write("operator breadcrumb")
    assert sp.gc() == 2
    assert os.path.isdir(os.path.join(entry, "step_backup"))
    assert os.path.exists(os.path.join(str(tmp_path), "notes.txt"))
    assert sp.get(key) is not None


def test_plan_spill_gc_compacts_plan_streams(tmp_path):
    ps = PlanSpill(str(tmp_path), keep_generations=3)
    key = ("dense", ("p",), "deadbeef")
    for i in range(3):
        ps.put(key, {"edges": np.arange(4) + i}, {"gen": i})
    assert ps.gc(keep=1) == 2
    arrays, meta = ps.get(key)
    assert np.array_equal(arrays["edges"], np.arange(4) + 2)
    assert meta["gen"] == 2


def test_service_init_gc_compacts_and_counts(tmp_path, g, queries):
    cfg = dict(device="cpu", v_max=4, tol=TOL, spill_dir=str(tmp_path))
    a = RankService(g, RankServiceConfig(spill_keep_generations=3, **cfg))
    a.rank(queries[:3])
    a.clear_result_cache()   # force re-convergence -> a second generation
    a.rank(queries[:3])
    a.flush_spill()
    keys = CacheSpill(str(tmp_path)).keys()
    assert any(len(_gens(os.path.join(str(tmp_path), k))) > 1 for k in keys)
    b = RankService(g, RankServiceConfig(spill_keep_generations=1, **cfg))
    assert b.stats["spill_gc_removed"] >= 1
    assert b.telemetry.counter("service.spill.gc_removed").value \
        == b.stats["spill_gc_removed"]
    for k in keys:
        assert len(_gens(os.path.join(str(tmp_path), k))) == 1
    assert all(r.status == "hit" for r in b.rank(queries[:3]))


def test_invalid_keep_generations_clamped(tmp_path):
    assert CacheSpill(str(tmp_path), keep_generations=0).keep_generations == 1
    assert CacheSpill(str(tmp_path), keep_generations=-5).keep_generations == 1
