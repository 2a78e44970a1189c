"""The offline ranking job in the port, on the CPU: edge partitioning,
the fault-tolerant ``RankingEngine`` and the ``launch.rank`` launcher,
each held to the JAX package's.

* ``partition_edges`` / ``partition_edges_by_dst_block``: equal arrays.
* ``RankingEngine``: equal iters, ``converged`` and ``stale_events``
  (stragglers are drawn from the same seeded generator in the same
  order), <= 1e-10 L1 on hub and authority, residual histories of equal
  length within 1e-14.
* A checkpoint written by either engine resumes in the other, to the
  result the writer's own package reaches from it.
* ``python -m repro_torch.launch.rank --device cpu`` against ``python -m
  repro.launch.rank`` on the same flags: the same graph lines, iters,
  convergence, stale events and top authorities.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.engine import RankingEngine as RefEngine
from repro.graph import paper_dataset as r_paper_dataset
from repro.graph import partition as r_partition
from repro_torch.core.engine import RankingEngine
from repro_torch.graph import from_reference, partition

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-10


@pytest.fixture(scope="module")
def rg():
    return r_paper_dataset("jobs", scale=0.05)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
@pytest.mark.parametrize("fn", ["partition_edges",
                                "partition_edges_by_dst_block"])
def test_partition_equal_reference(rg, fn, n_shards, weighted):
    w = None
    if weighted:
        w = np.random.default_rng(n_shards).random(rg.n_edges).astype(
            np.float32)
    ref = getattr(r_partition, fn)(rg, n_shards, w)
    got = getattr(partition, fn)(from_reference(rg), n_shards, w)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def assert_engines_equal(ref, got):
    assert got.iters == ref.iters and got.converged == ref.converged
    assert got.stale_events == ref.stale_events
    assert np.abs(got.hub - ref.hub).sum() <= 1e-10
    assert np.abs(got.authority - ref.authority).sum() <= 1e-10
    assert got.residuals.shape == ref.residuals.shape
    np.testing.assert_allclose(got.residuals, ref.residuals, rtol=0,
                               atol=1e-14)


@pytest.mark.parametrize("stragglers", [None, (0.3, 2), (0.6, 1)],
                         ids=["fresh", "p0.3-stale2", "p0.6-stale1"])
@pytest.mark.parametrize("n_shards", [1, 4, 8])
@pytest.mark.parametrize("algorithm", ["accel", "hits"])
def test_engine_matches_reference(rg, algorithm, n_shards, stragglers):
    kw = dict(n_shards=n_shards, seed=n_shards)
    if stragglers:
        kw.update(straggler_prob=stragglers[0], stale_limit=stragglers[1])
    ref = RefEngine(rg, algorithm, **kw).run(tol=TOL)
    got = RankingEngine(from_reference(rg), algorithm, device="cpu",
                        **kw).run(tol=TOL)
    assert got.converged
    if stragglers:
        assert got.stale_events > 0
    assert_engines_equal(ref, got)


def test_engine_max_iter_and_float32(rg):
    """A run cut by max_iter, and f32 vectors (1e-6 L1: f32 sums in other
    orders; equal iters)."""
    import jax.numpy as jnp
    ref = RefEngine(rg, "accel", n_shards=4).run(tol=1e-14, max_iter=7)
    got = RankingEngine(from_reference(rg), "accel", n_shards=4,
                        device="cpu").run(tol=1e-14, max_iter=7)
    assert not got.converged and got.iters == 7
    assert_engines_equal(ref, got)
    ref = RefEngine(rg, "accel", n_shards=4, dtype=jnp.float32).run(tol=1e-6)
    got = RankingEngine(from_reference(rg), "accel", n_shards=4,
                        dtype="float32", device="cpu").run(tol=1e-6)
    assert got.iters == ref.iters and got.hub.dtype == ref.hub.dtype
    assert np.abs(got.hub - ref.hub).sum() <= 1e-6


def test_engine_rejects_unknown_algorithm(rg):
    with pytest.raises(ValueError):
        RankingEngine(from_reference(rg), "pagerank", device="cpu")


@pytest.mark.parametrize("stragglers", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoint_resumes_across_packages(rg, tmp_path, writer,
                                            stragglers):
    """One package runs 8 sweeps with a checkpoint every 3; the other
    resumes from step 6 and converges to what the writer's package
    reaches when it resumes from the same checkpoint."""
    g = from_reference(rg)
    kw = dict(n_shards=4, checkpoint_every=3)
    if stragglers:
        kw.update(straggler_prob=0.3, stale_limit=2, seed=5)
    make = {"reference": lambda d: RefEngine(rg, "accel",
                                             checkpoint_dir=d, **kw),
            "port": lambda d: RankingEngine(g, "accel", checkpoint_dir=d,
                                            device="cpu", **kw)}
    reader = "port" if writer == "reference" else "reference"
    src = str(tmp_path / "ckpt")
    cut = make[writer](src).run(tol=TOL, max_iter=8)
    assert cut.iters == 8 and not cut.converged
    assert sorted(os.listdir(src)) == ["step_0000000003", "step_0000000006"]
    copies = {}
    for who in ("reference", "port"):
        copies[who] = str(tmp_path / who)
        shutil.copytree(src, copies[who])
    results = {who: make[who](copies[who]).run(tol=TOL, resume=True)
               for who in ("reference", "port")}
    full = make[writer](str(tmp_path / "fresh")).run(tol=TOL)
    for who in ("reference", "port"):
        assert results[who].converged
        # the 6 restored residuals (the last 20 are kept) come first
        assert len(results[who].residuals) == results[who].iters
    assert_engines_equal(results[writer], results[reader])
    assert np.abs(results[reader].hub - full.hub).sum() <= 1e-8


# ------------------------------------------------------------ launcher


def run_launcher(pkg, args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    extra = ["--device", "cpu"] if pkg == "repro_torch" else []
    out = subprocess.run([sys.executable, "-m", f"{pkg}.launch.rank"]
                         + args + extra, env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.splitlines()


def parse(lines):
    """(graph lines, {field: value} of the result line, top authorities)."""
    graph = [x for x in lines if x.startswith(("graph:", "back-button:"))]
    res = next(x for x in lines if x.startswith(("accel:", "hits:")))
    fields = dict(kv.split("=") for kv in res.split()[1:])
    top = json.loads(next(x for x in lines
                          if x.startswith("top authorities:"))
                     .split(":", 1)[1])
    return graph, fields, top


def assert_same_output(ref_lines, got_lines):
    rg_, rf, rt = parse(ref_lines)
    gg, gf, gt = parse(got_lines)
    assert gg == rg_
    for k in ("converged", "iters", "stale_events"):
        assert gf[k] == rf[k], k
    assert [t["page"] for t in gt] == [t["page"] for t in rt]
    np.testing.assert_allclose([t["score"] for t in gt],
                               [t["score"] for t in rt], rtol=0, atol=1e-12)


@pytest.mark.parametrize("flags", [
    ["--dataset", "wikipedia", "--scale", "0.1"],
    ["--dataset", "jobs", "--scale", "0.05", "--backbutton",
     "--algorithm", "hits", "--shards", "3", "--straggler-prob", "0.3",
     "--stale-limit", "2", "--topk", "5"],
    ["--dataset", "synthetic", "--n-nodes", "800", "--n-edges", "5000",
     "--dangling", "0.7", "--tol", "1e-11"]],
    ids=["wikipedia", "jobs-bb-stragglers", "synthetic"])
def test_launcher_matches_reference(flags):
    assert_same_output(run_launcher("repro", flags),
                       run_launcher("repro_torch", flags))


def test_launcher_resume_from_reference_checkpoint(tmp_path):
    """The reference's launcher writes checkpoints; the port's ``--resume``
    continues from them to the reference's own resumed result."""
    flags = ["--dataset", "wikipedia", "--scale", "0.1", "--backbutton",
             "--ckpt-every", "4"]
    ck = tmp_path / "ck"
    run_launcher("repro", flags + ["--ckpt", str(ck)])
    assert os.listdir(ck)
    shutil.copytree(ck, tmp_path / "ck2")
    ref = run_launcher("repro", flags + ["--ckpt", str(ck), "--resume"])
    got = run_launcher("repro_torch", flags + ["--ckpt",
                                               str(tmp_path / "ck2"),
                                               "--resume"])
    assert_same_output(ref, got)
