"""The paper's claims and the dense oracles in the port, on the CPU.

Mirrors ``tests/test_paper_claims.py`` (same datasets, SCALE 0.06, TOL
1e-9) and ``tests/test_hits_oracles.py``, and holds the port to the JAX
package on the same graphs: QI-HITS, accelerated HITS and PageRank on the
original and the back-button graphs with equal iters and <= 1e-10 L1 on
both vectors in f64; the metrics, the back-button edges, the dense oracles
and ``all_paper_datasets`` exactly equal. The paper's claims are then
asserted on the port's own results.
"""
import numpy as np
import pytest
import torch

from repro.core import accel_hits as r_accel
from repro.core import back_button as r_back_button
from repro.core import metrics as r_metrics
from repro.core import pagerank as r_pagerank
from repro.core import qi_hits as r_qi
from repro.core import ref_dense as r_dense
from repro.graph import WebGraphSpec, generate_webgraph
from repro.graph import all_paper_datasets as r_all_paper_datasets
from repro.graph import paper_dataset as r_paper_dataset
from repro_torch.core import (accel_hits, back_button, cosine, metrics,
                              pagerank, qi_hits, ref_dense, spearman)
from repro_torch.core.hits import EdgeList, hits_sweep
from repro_torch.core.power import power_method
from repro_torch.graph import all_paper_datasets, from_reference

SCALE = 0.06
TOL = 1e-9
DATASETS = ["wikipedia", "jobs", "opera"]
ALGOS = {"hits": (r_qi, qi_hits), "accel": (r_accel, accel_hits),
         "pr": (r_pagerank, pagerank)}
GRAPHS = [
    WebGraphSpec(n_nodes=150, n_edges=900, dangling_frac=0.5, seed=1),
    WebGraphSpec(n_nodes=300, n_edges=2500, dangling_frac=0.8, seed=2),
    WebGraphSpec(n_nodes=200, n_edges=600, dangling_frac=0.0, seed=3),
]


def graphs_of(name):
    """(reference graph, port graph) for the original and back-button
    versions of a Table-7 dataset at SCALE."""
    rg = r_paper_dataset(name, scale=SCALE)
    g = from_reference(rg)
    return {"orig": (rg, g), "bb": (r_back_button(rg), back_button(g))}


@pytest.fixture(scope="module")
def runs():
    """{(dataset, tag, algo): (reference result, port result)}."""
    out = {}
    for name in DATASETS:
        for tag, (rg, g) in graphs_of(name).items():
            for algo, (rf, pf) in ALGOS.items():
                out[name, tag, algo] = (rf(rg, tol=TOL),
                                        pf(g, tol=TOL, device="cpu"))
    return out


@pytest.fixture(scope="module")
def results(runs):
    """The port's results, shaped like the reference test's fixture."""
    out = {n: {"orig": {}, "bb": {}} for n in DATASETS}
    for (name, tag, algo), (_, got) in runs.items():
        out[name][tag][algo] = got
    return out


@pytest.mark.parametrize("algo", list(ALGOS))
@pytest.mark.parametrize("tag", ["orig", "bb"])
@pytest.mark.parametrize("name", DATASETS)
def test_runs_match_reference(runs, name, tag, algo):
    ref, got = runs[name, tag, algo]
    assert got.iters == ref.iters and got.converged == ref.converged
    assert np.abs(got.v - ref.v).sum() <= 1e-10
    assert np.abs(got.aux - ref.aux).sum() <= 1e-10


# ------------------------------------------ the paper's claims, on the port


def test_accel_faster_than_hits_original(results):
    """§4.2: on original datasets the proposed algorithm converges faster
    than HITS (one exception allowed across datasets)."""
    wins = sum(results[n]["orig"]["accel"].iters
               <= results[n]["orig"]["hits"].iters for n in DATASETS)
    assert wins >= len(DATASETS) - 1


def test_accel_fastest_on_back_button(results):
    """§4.2: in the back-button model the proposed algorithm beats BOTH
    HITS and PageRank on all datasets."""
    for n in DATASETS:
        r = results[n]["bb"]
        assert r["accel"].iters <= r["hits"].iters, n
        assert r["accel"].iters <= r["pr"].iters, n


def test_accel_margin_grows_on_back_button(results):
    """§4.2: the advantage over PageRank widens under the back-button
    model (the reference's documented form of the Fig. 3 effect)."""
    for n in DATASETS:
        o, b = results[n]["orig"], results[n]["bb"]
        margin_orig = o["pr"].iters / max(o["accel"].iters, 1)
        margin_bb = b["pr"].iters / max(b["accel"].iters, 1)
        assert margin_bb > margin_orig, n
        assert b["accel"].iters < 0.5 * b["pr"].iters, n


def test_similarity_to_qi_hits(results):
    """§4.4 Table 8: accelerated vectors approximate QI-HITS well."""
    cos_a = [cosine(results[n]["orig"]["accel"].aux,
                    results[n]["orig"]["hits"].aux) for n in DATASETS]
    cos_h = [cosine(results[n]["orig"]["accel"].v,
                    results[n]["orig"]["hits"].v) for n in DATASETS]
    assert np.mean(cos_a) > 0.6
    assert np.mean(cos_h) > 0.8


def test_degree_correlation_table1(results):
    """§3.1 Table 1: authority correlates with indegree, hub with
    outdegree."""
    for n in DATASETS:
        _, g = graphs_of(n)["orig"]
        r = results[n]["orig"]["hits"]
        assert cosine(r.aux, g.indeg().astype(float)) > 0.5
        assert spearman(r.v, g.outdeg().astype(float)) > 0.5


def test_warm_start_qi_hits_from_accel(results):
    """§5: accelerated vectors as a QI-HITS warm start reach the QI-HITS
    fixed point in no more sweeps than the uniform start, and in strictly
    fewer on the back-button graphs."""
    for n in DATASETS:
        for tag, (_, gg) in graphs_of(n).items():
            cold = results[n][tag]["hits"]
            warm0 = torch.from_numpy(results[n][tag]["accel"].v)
            warm = power_method(hits_sweep(EdgeList.from_graph(gg, "cpu")),
                                warm0, tol=TOL)
            assert np.abs(warm.v - cold.v).max() < 1e-7, (n, tag)
            assert warm.iters <= cold.iters, (n, tag)
            if tag == "bb":
                assert warm.iters < cold.iters, n


# ----------------------------------------------------- exact copies


def metric_inputs(seed):
    """Two vectors with ties (a few repeated values) and a constant one."""
    rng = np.random.default_rng(seed)
    x = rng.random(200)
    y = x + 0.3 * rng.random(200)
    x[rng.choice(200, 40)] = x[:5].repeat(8)
    y[:10] = 0.5
    return x, y


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_reference(seed):
    x, y = metric_inputs(seed)
    for fn in ("cosine", "spearman", "l1_residual"):
        assert getattr(metrics, fn)(x, y) == getattr(r_metrics, fn)(x, y), fn
    for k in (1, 10, 50):
        assert np.array_equal(metrics.topk(x, k), r_metrics.topk(x, k))
        assert metrics.topk_overlap(x, y, k) == r_metrics.topk_overlap(x, y,
                                                                       k)
    assert np.array_equal(metrics._rank(x), r_metrics._rank(x))
    const = np.full(50, 0.25)
    assert metrics.spearman(const, const) == r_metrics.spearman(const, const)
    assert metrics.cosine(np.zeros(5), x[:5]) == 0.0


@pytest.mark.parametrize("src", ["spec0", "spec1", "spec2"] + DATASETS)
def test_back_button_equal_reference(src):
    """Equal src/dst arrays, and the definition: every edge u->v with v
    dangling adds v->u, nothing else (``tests/test_hits_oracles.py``)."""
    if src in DATASETS:
        rg = r_paper_dataset(src, scale=SCALE)
    else:
        rg = generate_webgraph(GRAPHS[int(src[-1])])
    g = from_reference(rg)
    ref, bb = r_back_button(rg), back_button(g)
    assert bb.n_nodes == ref.n_nodes
    assert np.array_equal(bb.src, ref.src) and np.array_equal(bb.dst,
                                                              ref.dst)
    dang = g.dangling_mask()
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    expected = edges | {(v, u) for (u, v) in edges if dang[v]}
    assert set(zip(bb.src.tolist(), bb.dst.tolist())) == expected
    if dang.any():  # spec2 has no dangling page
        assert bb.dangling_fraction() < g.dangling_fraction()


@pytest.mark.parametrize("oracle", ["qi_hits_dense", "accel_hits_dense",
                                    "pagerank_dense"])
@pytest.mark.parametrize("spec", GRAPHS, ids=lambda s: f"seed{s.seed}")
def test_dense_oracles_equal_reference(spec, oracle):
    rg = generate_webgraph(spec)
    ref = getattr(r_dense, oracle)(rg, tol=1e-12)
    got = getattr(ref_dense, oracle)(from_reference(rg), tol=1e-12)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("spec", GRAPHS, ids=lambda s: f"seed{s.seed}")
def test_pagerank_matches_dense(spec):
    """``tests/test_hits_oracles.py``'s PageRank case, on the port."""
    rg = generate_webgraph(spec)
    p_d, k_d, _ = r_dense.pagerank_dense(rg, tol=1e-12)
    r = pagerank(from_reference(rg), tol=1e-12, device="cpu")
    assert r.iters == k_d
    np.testing.assert_allclose(r.v, p_d, atol=1e-12)
    assert np.isclose(r.v.sum(), 1.0, atol=1e-8)


@pytest.mark.parametrize("kw", [{"v": 4}, {"alpha": 0.5},
                                {"check_every": 3}, {"max_iter": 5},
                                {"dtype": "float32", "tol": 1e-6}],
                         ids=["v4", "alpha", "check3", "maxiter", "f32"])
def test_pagerank_options_match_reference(kw):
    """Multi-column starts, another damping, sparse residual checks, a run
    cut by max_iter and f32 (1e-6 L1: f32 sums in other orders)."""
    import jax.numpy as jnp
    rg = generate_webgraph(GRAPHS[1])
    kw = dict(kw)
    kw.setdefault("tol", 1e-12)
    rkw = dict(kw)
    if "dtype" in rkw:
        rkw["dtype"] = jnp.float32
    ref = r_pagerank(rg, **rkw)
    got = pagerank(from_reference(rg), device="cpu", **kw)
    l1 = 1e-6 if "dtype" in kw else 1e-10
    assert got.iters == ref.iters and got.converged == ref.converged
    assert got.v.shape == ref.v.shape and got.v.dtype == ref.v.dtype
    assert np.abs(got.v - ref.v).sum() <= l1


def test_multivector_iteration_consistent():
    """V-column batched iteration == V separate runs (same start)."""
    g = from_reference(generate_webgraph(GRAPHS[0]))
    r1 = accel_hits(g, tol=1e-12, v=1, device="cpu")
    r4 = accel_hits(g, tol=1e-12, v=4, device="cpu")
    for j in range(4):
        np.testing.assert_allclose(r4.v[:, j], r1.v, atol=1e-10)


def test_all_paper_datasets_equal_reference():
    ref = r_all_paper_datasets(scale=0.01, seed=3)
    got = all_paper_datasets(scale=0.01, seed=3)
    assert list(got) == list(ref)
    for name, rg in ref.items():
        g = got[name]
        assert g.n_nodes == rg.n_nodes
        assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst,
                                                                rg.dst)
