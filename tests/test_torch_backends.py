"""The port's sweep backends and plans against the JAX package's, on
identical ``SweepBatch``es (f64; the port on the CPU through its plain
versions, the reference's Pallas kernel in interpret mode)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve.backends as rb
import repro.serve.plans as rplans
import repro_torch.serve.backends as pb
import repro_torch.serve.plans as pplans
from repro.core.weights import accel_weights
from repro.graph.structure import next_pow2


def make_batch(seed, n, v, tol=1e-10, max_iter=200, rank_k=0, quiet=0):
    """A service-shaped padded reference batch: sentinel edges into the
    dead pad row, per-column random base sets with their induced accel
    weights, uniform-over-support starts. The last ``quiet`` nodes get no
    edges (rows the lumped reduction drops)."""
    rng = np.random.default_rng(seed)
    n_pad = next_pow2(max(n + 1, 16))
    e = int(rng.integers(2 * n, 6 * n))
    e_pad = next_pow2(max(e, 16))
    src = np.full(e_pad, n_pad - 1, np.int32)
    dst = np.full(e_pad, n_pad - 1, np.int32)
    w = np.zeros(e_pad)
    src[:e] = rng.integers(0, n - quiet, e)
    dst[:e] = rng.integers(0, n - quiet, e)
    w[:e] = 1
    ca, ch, mask, h0 = (np.zeros((n_pad, v)) for _ in range(4))
    for j in range(v):
        m = np.zeros(n_pad)
        m[rng.choice(n, size=max(4, n // 2), replace=False)] = 1.0
        sel = (m[src] > 0) & (m[dst] > 0) & (w > 0)
        ca_j, ch_j = accel_weights(np.bincount(dst[sel], minlength=n_pad),
                                   np.bincount(src[sel], minlength=n_pad))
        ca[:, j], ch[:, j], mask[:, j] = ca_j * m, ch_j * m, m
        h0[:, j] = m / m.sum()
    return rb.SweepBatch(h0=h0, src=src, dst=dst, w=w, ca=ca, ch=ch,
                         mask=mask, tol=tol, max_iter=max_iter,
                         dtype=jnp.float64, rank_k=rank_k)


def port_batch(b, **kw):
    """The same batch for the port: identical arrays, dtypes by name."""
    fields = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    fields["dtype"] = "float64"
    fields["bulk_dtype"] = None if b.bulk_dtype is None else \
        str(np.dtype(b.bulk_dtype))
    fields.update(kw)
    return pb.SweepBatch(**fields)


def agree(got, want, conv_equal=True):
    assert np.abs(got[0] - want[0]).sum(axis=0).max() <= 1e-10
    assert np.abs(got[1] - want[1]).sum(axis=0).max() <= 1e-10
    if conv_equal:
        assert np.array_equal(got[2], want[2]), (got[2], want[2])


# ------------------------------------------------------- dtypes and keys


@pytest.mark.parametrize("name", ["bf16", "fp32", "f64", "float32"])
def test_dtype_helpers_match_reference(name):
    """torch.finfo eps equals jnp.finfo eps for all three dtypes, so the
    floors, the switch-over tolerance and the ladder keys are the same."""
    canon = pb.resolve_sweep_dtype(name)
    assert canon == str(rb.resolve_sweep_dtype(name))
    assert pb.dtype_floor(canon) == rb.dtype_floor(rb.resolve_sweep_dtype(name))
    assert pb.bulk_stop_tol(canon, 1e-10) == \
        rb.bulk_stop_tol(rb.resolve_sweep_dtype(name), 1e-10)
    assert pb.resolve_sweep_dtype("") is None
    with pytest.raises(ValueError):
        pb.resolve_sweep_dtype("fp8")


def test_structure_keys_match_reference():
    b = make_batch(0, 40, 3)
    p = port_batch(b)
    assert p.structure_key() == b.structure_key()
    for dt, name in ((jnp.float64, "float64"), (jnp.float32, "float32"),
                     (jnp.bfloat16, "bfloat16")):
        assert pplans.structure_key(b.src, b.dst, b.w, 64, name) == \
            rplans.structure_key(b.src, b.dst, b.w, 64, dt)
        assert pplans.topology_key(b.src, b.dst, 64, name) == \
            rplans.topology_key(b.src, b.dst, 64, dt)
    lad = dataclasses.replace(b, bulk_dtype=np.dtype(jnp.bfloat16))
    assert port_batch(lad).ladder_key() == lad.ladder_key() == "bfloat16"
    assert port_batch(lad).bulk_tol() == lad.bulk_tol()


def test_plan_cache_lru():
    c = pplans.PlanCache(2)
    c.put(("a",), 1)
    c.put(("b",), 2)
    assert c.get(("a",)) == 1
    c.put(("c",), 3)  # evicts b, the least recently used
    assert c.get(("b",)) is None and len(c) == 2
    assert c.stats == {"hits": 1, "misses": 1, "evictions": 1}
    off = pplans.PlanCache(0)
    off.put(("a",), 1)
    assert off.get(("a",)) is None


@pytest.mark.parametrize("seed", [0, 1])
def test_lump_batch_and_unlump_match_reference(seed):
    b = make_batch(seed, 50, 3, quiet=12)
    red_r, map_r = rplans.lump_batch(b)
    assert map_r is not None and map_r.lumped_nodes > 0
    red_p, map_p = pplans.lump_batch(port_batch(b))
    assert map_p.key == map_r.key and map_p.n_red == map_r.n_red
    assert np.array_equal(map_p.scatter, map_r.scatter)
    for f in ("h0", "src", "dst", "w", "ca", "ch", "mask"):
        assert np.array_equal(getattr(red_p, f), getattr(red_r, f)), f
    h = np.random.default_rng(seed).random((map_r.n_red, 3))
    for x, y in zip(pplans.unlump_cols(h, h, map_p),
                    rplans.unlump_cols(h, h, map_r)):
        assert np.array_equal(x, y)


# -------------------------------------------------------------- backends


@pytest.fixture(scope="module")
def batches():
    return [make_batch(s, 40 + 13 * s, 1 + s % 4, rank_k=5 * (s % 2))
            for s in range(4)]


@pytest.fixture(scope="module")
def reference_dense(batches):
    return [rb.DenseSweepBackend().converge(b) for b in batches]


@pytest.mark.parametrize("kind,kw", [
    ("dense", {}), ("bsr", {"fused": True}), ("bsr", {"fused": False}),
    ("bsr16", {"fused": True})])
def test_port_backends_match_reference_dense(batches, reference_dense, kind,
                                             kw):
    """dense, bsr (device loop and host loop) and bsr at bs=16: h and a
    within 1e-10 L1 and conv equal to the reference's dense backend, with
    rank_k 0 and 5. Results come back as numpy, certificates included."""
    if kind == "dense":
        be = pb.DenseSweepBackend(device="cpu")
    else:
        be = pb.BsrSweepBackend(bs=16 if kind == "bsr16" else 32,
                                device="cpu", **kw)
    for b, want in zip(batches, reference_dense):
        got = be.converge(port_batch(b))
        assert all(isinstance(x, np.ndarray) for x in got)
        agree(got, want)
        np.testing.assert_allclose(got[3], np.asarray(want[3]), rtol=0,
                                   atol=1e-12)


def test_port_bsr_matches_reference_bsr_fused(batches):
    be_r = rb.BsrSweepBackend(bs=32, interpret=True)
    be_p = pb.BsrSweepBackend(bs=32, device="cpu")
    for b in batches[:2]:
        agree(be_p.converge(port_batch(b)), be_r.converge(b))


def test_reference_plan_restores_into_the_port(batches):
    """A plan built by the JAX package, persisted as its ``plan_arrays``,
    restores into the port (``plan_restore``) and sweeps the same operator
    to the reference's results; the port's own plan persists to the same
    arrays."""
    b = dataclasses.replace(batches[2], bulk_dtype=np.dtype(jnp.bfloat16))
    be_r = rb.BsrSweepBackend(bs=32, interpret=True)
    plan_r = be_r.plan(b)
    arrays, meta = be_r.plan_arrays(plan_r)
    be_p = pb.BsrSweepBackend(bs=32, device="cpu")
    restored = be_p.plan_restore("k", arrays, meta)
    assert restored.lt_lo is not None and \
        restored.lt_lo.blocks.dtype == torch.bfloat16
    p = port_batch(b)
    agree(be_p.sweep(restored, p), be_r.sweep(plan_r, b))
    own_arrays, own_meta = be_p.plan_arrays(be_p.plan(p))
    assert own_meta == meta
    for k, x in arrays.items():
        assert np.array_equal(own_arrays[k], x), k
    with pytest.raises(ValueError):
        pb.BsrSweepBackend(bs=16, device="cpu").plan_restore("k", arrays,
                                                             meta)


def test_dense_plan_roundtrip(batches):
    be = pb.DenseSweepBackend(device="cpu")
    p = port_batch(batches[0])
    plan = be.plan(p)
    arrays, meta = be.plan_arrays(plan)
    again = be.plan_restore(plan.key, arrays, meta)
    for x, y in zip(be.sweep(again, p), be.sweep(plan, p)):
        assert np.array_equal(x, y)
    with pytest.raises(ValueError):
        be.sweep(plan, port_batch(make_batch(0, 200, 2)))


def test_selection_and_factory():
    assert pb.select_backend(100, 900, cuda=True) == "bsr"
    assert pb.select_backend(100, 900, cuda=False) == "dense"
    assert pb.select_backend(100, 500, cuda=True) == "dense"
    assert pb.select_backend(100, 9000, n_devices=4) == "sharded"
    assert isinstance(pb.make_backend("bsr", device="cpu"), pb.BsrSweepBackend)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pb.make_backend("sharded", device="cpu")
    with pytest.raises(ValueError):
        pb.make_backend("nope", device="cpu")


def test_cuda_device_required_unless_cpu_asked(monkeypatch):
    """Backends default to the card; without one they raise rather than
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kind in ("dense", "bsr"):
        with pytest.raises(RuntimeError, match="cuda"):
            pb.make_backend(kind)


# ------------------------------------------------------ sweeps and SpMV


@pytest.mark.parametrize("zeta", [1.0, 0.85])
def test_spmv_and_sweeps_match_reference(zeta):
    """``sparse.spmv`` (segmented sums over target-sorted edges) and the
    ``core.hits`` sweeps against the reference's gather + segment_sum, f64
    at rtol 1e-13 (same products, sums in edge order on both sides)."""
    import repro.core.hits as rhits
    import repro.sparse.spmv as rspmv
    import repro_torch.core.hits as phits
    import repro_torch.sparse.spmv as pspmv
    from repro.graph import WebGraphSpec, generate_webgraph
    from repro_torch.graph import from_reference
    g = generate_webgraph(WebGraphSpec(150, 900, 0.5, seed=4))
    rng = np.random.default_rng(7)
    x, w = rng.random((g.n_nodes, 3)), rng.random(g.n_edges)
    src, dst = jnp.asarray(g.src), jnp.asarray(g.dst)
    ts, td = torch.tensor(g.src).long(), torch.tensor(g.dst).long()

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-13,
                                   atol=1e-16)

    for f in ("spmv_dst", "spmv_src"):
        close(getattr(pspmv, f)(torch.tensor(x), ts, td, g.n_nodes,
                                torch.tensor(w)),
              getattr(rspmv, f)(jnp.asarray(x), src, dst, g.n_nodes,
                                jnp.asarray(w)))
    close(pspmv.normalize_l1(torch.tensor(x)), rspmv.normalize_l1(x))
    close(pspmv.residual_l1(torch.tensor(x), torch.tensor(x[::-1].copy())),
          rspmv.residual_l1(jnp.asarray(x), jnp.asarray(x[::-1])))
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    edges = phits.EdgeList.from_graph(from_reference(g), device="cpu")
    h = rng.random(g.n_nodes)
    got = phits.hits_sweep(edges, torch.tensor(ca), torch.tensor(ch),
                           zeta=zeta)(torch.tensor(h))
    want = rhits.hits_sweep(rhits.EdgeList.from_graph(g), jnp.asarray(ca),
                            jnp.asarray(ch), zeta=zeta)(jnp.asarray(h))
    for a, b in zip(got, want):
        close(a, b)
    m = (rng.random((g.n_nodes, 3)) > 0.4).astype(float)
    got = phits.hits_sweep_cols(edges, torch.tensor(m * ca[:, None]),
                                torch.tensor(m * ch[:, None]),
                                torch.tensor(m))(torch.tensor(x))
    want = rhits.hits_sweep_cols(rhits.EdgeList.from_graph(g),
                                 jnp.asarray(m * ca[:, None]),
                                 jnp.asarray(m * ch[:, None]),
                                 jnp.asarray(m))(jnp.asarray(x))
    for a, b in zip(got, want):
        close(a, b)
