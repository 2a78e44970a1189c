"""The port's sharded serving backend (``serve/backends.py``:
``ShardedSweepBackend`` over ``sparse/dist.py``) on the CPU against the
JAX package's, at the same (shard mode, shard count): S logical shards
in one process here, S forced host devices there.

The reference results come from one subprocess that runs this file as a
script with ``--xla_force_host_platform_device_count=8`` (its mesh needs
S devices) and ``--xla_allow_excess_precision=false`` (XLA on the CPU
otherwise skips the bf16 roundings the reference's source writes). The
same subprocess restores the spill directories the port wrote, and writes
its own for the port to restore.

Cases, on ``WebGraphSpec(260, 2000, 0.5, seed=2)`` with 4 queries of 4
roots, ``v_max=4``, tol 1e-12: cold, cache-hit and warm batches for
S in {1, 2, 3, 4, 8} in both modes; the bf16, fp32 and f64 ladders at S
in {1, 2, 4, 8}; ``lumping="on"``; ``rank_k``; a weight-only delta
patching the sharded plan; spill directories in both directions; the
shared mesh; the pipeline and the queue at 2 shards.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.graph import from_reference
from repro_torch.serve import (PipelineJob, RankService, RankServiceConfig,
                               ShardedSweepBackend, shared_mesh)

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-12
WAIT = 120  # seconds any ticket or join may take before the test fails
MODES = ("replicated", "dual_blocked")
SHARDS = (1, 2, 3, 4, 8)
LADDER = [(m, sd, s) for m in MODES for sd in ("bfloat16", "float32",
                                               "float64")
          for s in (1, 2, 4, 8)]
LUMPED = [(m, s) for m in MODES for s in (2, 3)]
STATUS = {"hit": 0, "warm": 1, "cold": 2}


def ref_graph():
    from repro.graph import WebGraphSpec, generate_webgraph
    return generate_webgraph(WebGraphSpec(260, 2000, 0.5, seed=2))


def queries():
    rng = np.random.default_rng(0)
    return [rng.choice(260, size=4, replace=False) for _ in range(4)]


def config(mode, s, **kw):
    return dict(v_max=4, tol=TOL, backend="sharded", shard_mode=mode,
                shard_devices=s, **kw)


def serve(svc):
    """Cold batch, the repeat (cache hits), a refresh (warm starts)."""
    qs = queries()
    return svc.rank(qs) + svc.rank(qs) + svc.rank(qs, refresh=True)


def summarize(prefix, results, out):
    for i, r in enumerate(results):
        out[f"{prefix}/{i}/a"] = np.asarray(r.authority)
        out[f"{prefix}/{i}/h"] = np.asarray(r.hub)
        out[f"{prefix}/{i}/nodes"] = np.asarray(r.nodes)
        out[f"{prefix}/{i}/meta"] = np.array(
            [r.iters, STATUS[r.status],
             np.nan if r.residual is None else r.residual])


def union_edge(svc, roots):
    """A (src, dst) global edge inside this root set's union subgraph."""
    fs = svc.extractor.extract(np.asarray(roots))
    return (int(fs.nodes[fs.graph.src[0]]), int(fs.nodes[fs.graph.dst[0]]))


def delta_run(svc):
    """Serve, reweight one union edge of the first query by 3.0, serve
    again: the results after the delta and the delta counters."""
    qs = queries()
    svc.rank(qs)
    u, v = union_edge(svc, qs[0])
    svc.apply_edge_delta(reweights=[(u, v, 3.0)])
    res = svc.rank(qs)
    snap = svc.telemetry_snapshot()
    return res, np.array([snap["service.delta.patched"]["sharded"],
                          snap["service.delta.replanned"],
                          svc.stats["plan_misses"]])


def restore_run(svc):
    """A reader on a spill directory: every entry restored and served as
    a hit, then, with the vectors cleared, swept again through the
    restored plans. Returns the swept results and [restored, hits,
    plan_restored, plan_misses]."""
    qs = queries()
    restored = svc.stats["spill_restored"]
    hits = sum(r.status == "hit" for r in svc.rank(qs))
    svc.clear_result_cache()
    res = svc.rank(qs)
    return res, np.array([restored, hits, svc.stats["plan_restored"],
                          svc.stats["plan_misses"]])


def compute_oracle(path, port_spill, ref_spill):
    import jax
    jax.config.update("jax_enable_x64", True)
    assert len(jax.devices()) == 8, jax.devices()
    from repro.serve import RankService, RankServiceConfig
    g = ref_graph()
    out = {}

    def svc(**kw):
        return RankService(g, RankServiceConfig(**kw))

    for mode in MODES:
        for s in SHARDS:
            summarize(f"base/{mode}/{s}", serve(svc(**config(mode, s))), out)
        res, counts = delta_run(svc(**config(mode, 2)))
        summarize(f"delta/{mode}", res, out)
        out[f"delta/{mode}/counts"] = counts
        summarize(f"rank/{mode}", svc(**config(mode, 2, rank_k=4))
                  .rank(queries()), out)
        # the reference reads the port's spill dir, then writes its own
        res, counts = restore_run(svc(**config(
            mode, 2, spill_dir=os.path.join(port_spill, mode))))
        summarize(f"spill/port/{mode}", res, out)
        out[f"spill/port/{mode}/counts"] = counts
        summarize(f"spill/repro/{mode}", svc(**config(
            mode, 2, spill_dir=os.path.join(ref_spill, mode))).rank(queries()),
            out)
    for mode, sd, s in LADDER:
        summarize(f"ladder/{mode}/{sd}/{s}",
                  serve(svc(**config(mode, s, sweep_dtype=sd))), out)
    for mode, s in LUMPED:
        summarize(f"lump/{mode}/{s}",
                  serve(svc(**config(mode, s, lumping="on"))), out)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def g():
    return from_reference(ref_graph())


def port(g, **kw):
    return RankService(g, RankServiceConfig(device="cpu", **kw))


@pytest.fixture(scope="module")
def spills(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_spill")
    return root / "port", root / "repro"


@pytest.fixture(scope="module")
def port_written(g, spills):
    """The port's spill dirs (S=2, each mode) and its cold results, made
    before the reference's subprocess reads them."""
    out = {}
    for mode in MODES:
        svc = port(g, **config(mode, 2, spill_dir=str(spills[0] / mode)))
        out[mode] = svc.rank(queries())
    return out


@pytest.fixture(scope="module")
def oracle(tmp_path_factory, spills, port_written):
    path = tmp_path_factory.mktemp("sharded_oracle") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, __file__, str(path),
                          str(spills[0]), str(spills[1])], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def assert_matches(oracle, prefix, results, l1=1e-10, iters=True):
    """Per query: equal nodes and status, scores within ``l1`` L1, equal
    iters, the residual certificate within 1e-12 of the reference's."""
    assert f"{prefix}/0/meta" in oracle, prefix
    for i, r in enumerate(results):
        k = f"{prefix}/{i}/"
        want = oracle[k + "meta"]
        assert np.array_equal(r.nodes, oracle[k + "nodes"]), k
        assert STATUS[r.status] == want[1], (k, r.status, want)
        if iters:
            assert r.iters == want[0], (k, r.iters, want)
            assert abs(r.residual - want[2]) <= 1e-12, (k, r.residual, want)
        for f, x in (("a", r.authority), ("h", r.hub)):
            d = np.abs(np.asarray(x) - oracle[k + f]).sum()
            assert d <= l1, (k + f, d)


@pytest.mark.parametrize("s", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_matches_reference(oracle, g, mode, s):
    """Cold, cache-hit and warm batches at the reference's (mode, S):
    equal nodes, iters and status, scores within 1e-10 L1, certificates
    <= tol; only the sharded backend ran."""
    svc = port(g, **config(mode, s))
    res = serve(svc)
    assert_matches(oracle, f"base/{mode}/{s}", res)
    assert all(r.residual <= TOL for r in res[:4])
    assert svc.stats["backend_batches"] == {"sharded": 2}
    plan = next(iter(svc._plans._plans.values()))
    assert plan.n_shards == s and plan.mesh.size == s


@pytest.mark.parametrize("mode,sweep_dtype,s", LADDER)
def test_sharded_ladder_matches_reference(oracle, g, mode, sweep_dtype, s):
    """The precision ladder (bulk sweeps at bf16/fp32, then the f64
    polish; f64 is the single phase) at the reference's (mode, S): equal
    iters and status, within 1e-10 L1, certificates <= tol."""
    res = serve(port(g, **config(mode, s, sweep_dtype=sweep_dtype)))
    assert_matches(oracle, f"ladder/{mode}/{sweep_dtype}/{s}", res)
    assert all(r.residual <= TOL for r in res[:4])


@pytest.mark.parametrize("mode,s", LUMPED)
def test_sharded_lumping_matches_reference(oracle, g, mode, s):
    """``lumping="on"``: the reduced sweep on the mesh and the exact
    unlump give the reference's results."""
    assert_matches(oracle, f"lump/{mode}/{s}",
                   serve(port(g, **config(mode, s, lumping="on"))))


@pytest.mark.parametrize("mode", MODES)
def test_sharded_rank_k_matches_reference(oracle, g, mode):
    """``rank_k=4`` at 2 shards: the rank-stability stop ranks the node
    rows of ``a`` (blocked rows gathered, dead rows last) and stops each
    query at the reference's sweep with its top-k."""
    res = port(g, **config(mode, 2, rank_k=4)).rank(queries())
    assert_matches(oracle, f"rank/{mode}", res)
    for i, r in enumerate(res):
        want = oracle[f"rank/{mode}/{i}/a"]
        top = [n for n, _ in r.topk(4)]
        assert top == [int(r.nodes[j]) for j in np.argsort(-want)[:4]]


@pytest.mark.parametrize("mode", MODES)
def test_sharded_weight_delta_patches(oracle, g, mode):
    """A weight-only delta patches the sharded plan (only the weight
    planes ship; never replanned) and serves the reference's results."""
    res, counts = delta_run(port(g, **config(mode, 2)))
    assert counts[0] >= 1 and counts[1] == 0, counts
    assert np.array_equal(counts, oracle[f"delta/{mode}/counts"])
    assert_matches(oracle, f"delta/{mode}", res)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("writer", ["port", "repro"])
def test_sharded_spill_crosses_packages(oracle, g, spills, port_written,
                                        mode, writer):
    """A sharded spill directory (S=2) one package wrote serves in the
    other: every entry restores and hits, then, with the vectors cleared,
    the reader sweeps through the writer's plans (none rebuilt) to the
    writer's iters, within 1e-10 L1."""
    if writer == "port":
        counts = oracle[f"spill/port/{mode}/counts"]
        for i, c in enumerate(port_written[mode]):
            k = f"spill/port/{mode}/{i}/"
            assert oracle[k + "meta"][0] == c.iters
            assert np.abs(oracle[k + "a"] - c.authority).sum() <= 1e-10
            assert np.abs(oracle[k + "h"] - c.hub).sum() <= 1e-10
    else:
        res, counts = restore_run(port(g, **config(
            mode, 2, spill_dir=str(spills[1] / mode))))
        assert_matches(oracle, f"spill/repro/{mode}", res, iters=False)
        for i, r in enumerate(res):
            assert r.iters == oracle[f"spill/repro/{mode}/{i}/meta"][0]
    assert counts[0] == 4 and counts[1] == 4, counts
    assert counts[2] >= 1 and counts[3] == 0, counts


def test_sharded_plan_round_trips_in_process(g):
    """plan_arrays -> plan_restore gives the same (S, per) arrays and the
    same sweep, bit for bit, in both modes, also for a bf16 plan."""
    svc = port(g, v_max=4, tol=TOL)
    asm = svc.pipeline.assemble(PipelineJob(
        queries=[svc.validate_roots(q) for q in queries()]))
    for mode in MODES:
        be = ShardedSweepBackend(mode=mode, n_devices=3, device="cpu")
        for dt in ("float64", "bfloat16"):
            b = dataclasses.replace(asm.batch, dtype=dt)
            plan = be.plan(b)
            arrays, meta = be.plan_arrays(plan)
            assert all(a.shape == (3, plan.per) for a in arrays.values())
            again = be.plan_restore(plan.key, arrays, meta)
            for x, y in zip(be.sweep(again, b), be.sweep(plan, b)):
                assert np.array_equal(x, y)
        with pytest.raises(ValueError):
            ShardedSweepBackend(mode=mode, n_devices=2,
                                device="cpu").plan_restore(plan.key, arrays,
                                                           meta)


def test_sharded_mesh_built_once_and_shared(g):
    """Repeat batches, fresh services and fresh backend instances over one
    device tuple hold the SAME mesh object."""
    q1, q2 = np.arange(4), np.arange(100, 104)
    svc = port(g, **config("dual_blocked", 1))
    svc.rank([q1])
    svc.rank([q2])
    plans = list(svc._plans._plans.values())
    assert len(plans) == 2 and plans[0].mesh is plans[1].mesh
    be = svc._backends["sharded"]
    assert plans[0].mesh is be.mesh
    assert ShardedSweepBackend(n_devices=1, device="cpu").mesh is be.mesh
    svc2 = port(g, **config("dual_blocked", 1))
    svc2.rank([q1])
    assert next(iter(svc2._plans._plans.values())).mesh is be.mesh
    assert shared_mesh(be.mesh.devices, ("data",)) is be.mesh
    four = ShardedSweepBackend(n_devices=4, device="cpu").mesh
    assert four is not be.mesh and four.size == 4
    assert set(four.devices) == {torch.device("cpu")}


def test_sharded_pipeline_depths(oracle, g):
    """At 2 shards the depth-2 pipeline stays within 1e-10 of the serial
    schedule and repeats itself bit for bit; the first batch is the
    reference's cold batch."""
    qs = queries()
    stream = qs + [np.concatenate([q[:3], [7]]) for q in qs] + qs[:2]

    def run(depth):
        svc = port(g, pipeline_depth=depth, **config("dual_blocked", 2))
        out = svc.rank(stream)
        assert svc.pipeline.stats["runs"] == 1
        return out

    serial = run(1)
    piped = [run(2), run(2)]
    assert_matches(oracle, "base/dual_blocked/2", serial[:4])
    for res in piped:
        for a, b in zip(res, serial):
            assert np.abs(a.authority - b.authority).sum() <= 1e-10
            assert np.abs(a.hub - b.hub).sum() <= 1e-10
    for a, b in zip(*piped):
        assert a.status == b.status and a.iters == b.iters
        assert np.array_equal(a.authority, b.authority)


@pytest.mark.parametrize("mode", MODES)
def test_sharded_queue(oracle, g, mode):
    """The queued frontend over a 2-shard service: the 4 root sets flush
    as one batch by width and serve the reference's cold results within
    1e-10 L1; resubmitted, they are cache hits."""
    svc = port(g, **config(mode, 2))
    q = svc.queue(deadline_ms=60_000)
    try:
        first = [t.result(timeout=WAIT) for t in
                 [q.submit(x) for x in queries()]]
        again = [t.result(timeout=WAIT) for t in
                 [q.submit(x) for x in queries()]]
    finally:
        q.close(wait=False)
        q._thread.join(timeout=WAIT)
        assert not q._thread.is_alive(), "the dispatcher did not stop"
        q.flush()
    assert_matches(oracle, f"base/{mode}/2", first, iters=False)
    assert all(r.status == "hit" for r in again)
    assert svc.stats["backend_batches"] == {"sharded": 1}


if __name__ == "__main__":
    compute_oracle(*sys.argv[1:4])
