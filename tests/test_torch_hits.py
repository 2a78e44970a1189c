"""The paper's whole-graph algorithms in the port (``core.power``,
``core.hits``: ``qi_hits``, ``accel_hits``, the §3.4 ``zeta`` fix and
``authority_sweep``) against the JAX package's, on the CPU.

Mirrors ``tests/test_hits_oracles.py`` and ``tests/test_uniqueness.py``:
each case runs the reference function and its port on the same graph and
start, and holds the port to it: 1e-10 L1 on both vectors, equal
``iters`` and ``converged``, and residual histories of equal length that
agree to 1e-14 (they measure vectors that agree to ~1e-16; the two sum
in different orders, so the histories differ in the last bits). The
reference's own dense-oracle assertions hold for the port too.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accel_hits as r_accel
from repro.core import qi_hits as r_qi
from repro.core.hits import EdgeList as REdgeList
from repro.core.hits import authority_sweep as r_authority_sweep
from repro.core.hits import uniform_start as r_uniform_start
from repro.core.power import power_method as r_power
from repro.core.ref_dense import accel_hits_dense, qi_hits_dense
from repro.graph import Graph, WebGraphSpec, generate_webgraph
from repro_torch.core import accel_hits, qi_hits
from repro_torch.core.hits import EdgeList, authority_sweep, uniform_start
from repro_torch.core.power import power_method
from repro_torch.graph import from_reference

GRAPHS = [
    WebGraphSpec(n_nodes=150, n_edges=900, dangling_frac=0.5, seed=1),
    WebGraphSpec(n_nodes=300, n_edges=2500, dangling_frac=0.8, seed=2),
    WebGraphSpec(n_nodes=200, n_edges=600, dangling_frac=0.0, seed=3),
]
ALGOS = {"qi": (r_qi, qi_hits), "accel": (r_accel, accel_hits)}


def assert_same(ref, got, l1=1e-10):
    assert got.iters == ref.iters and got.converged == ref.converged
    assert got.v.shape == ref.v.shape and got.aux.shape == ref.aux.shape
    assert np.abs(got.v - ref.v).sum() <= l1
    assert np.abs(got.aux - ref.aux).sum() <= l1
    assert got.residuals.shape == ref.residuals.shape
    np.testing.assert_allclose(got.residuals, ref.residuals, rtol=0,
                               atol=1e-14)


def run(algo, g, **kw):
    rf, pf = ALGOS[algo]
    return rf(g, **kw), pf(from_reference(g), device="cpu", **kw)


@pytest.mark.parametrize("spec", GRAPHS, ids=lambda s: f"seed{s.seed}")
@pytest.mark.parametrize("algo", ["qi", "accel"])
def test_matches_reference_and_dense_oracle(algo, spec):
    g = generate_webgraph(spec)
    ref, got = run(algo, g, tol=1e-12)
    assert_same(ref, got)
    dense = {"qi": qi_hits_dense, "accel": accel_hits_dense}[algo]
    a_d, h_d, k_d, _ = dense(g, tol=1e-12)
    assert got.iters == k_d
    np.testing.assert_allclose(got.aux, a_d, atol=1e-12)
    np.testing.assert_allclose(got.v, h_d, atol=1e-12)


@pytest.mark.parametrize("algo", ["qi", "accel"])
@pytest.mark.parametrize("kw", [{"v": 4}, {"zeta": 0.99},
                                {"check_every": 3}, {"max_iter": 5},
                                {"dtype": "float32", "tol": 1e-6}],
                         ids=["v4", "zeta", "check3", "maxiter", "f32"])
def test_options_match_reference(algo, kw):
    """Multi-column starts, the primitivity fix, sparse residual checks,
    a run stopped by max_iter, and f32 (held to 1e-6 L1, an f32 rounding
    of sums taken in other orders, with equal iters)."""
    g = generate_webgraph(GRAPHS[0])
    kw = dict(kw)
    if "tol" not in kw:
        kw["tol"] = 1e-12
    rkw = dict(kw)
    if "dtype" in rkw:
        rkw["dtype"] = jnp.float32
    rf, pf = ALGOS[algo]
    ref = rf(g, **rkw)
    got = pf(from_reference(g), device="cpu", **kw)
    if "dtype" in kw:
        assert got.v.dtype == np.float32 and got.iters == ref.iters
        assert np.abs(got.v - ref.v).sum() <= 1e-6
        assert np.abs(got.aux - ref.aux).sum() <= 1e-6
    else:
        assert_same(ref, got)


def test_multivector_iteration_consistent():
    """V-column batched iteration == V separate runs (same start)."""
    g = from_reference(generate_webgraph(GRAPHS[0]))
    r1 = accel_hits(g, tol=1e-12, v=1, device="cpu")
    r4 = accel_hits(g, tol=1e-12, v=4, device="cpu")
    for j in range(4):
        np.testing.assert_allclose(r4.v[:, j], r1.v, atol=1e-10)


def test_zeta_gives_positive_vector():
    g = generate_webgraph(WebGraphSpec(200, 1200, 0.7, seed=4))
    ref, got = run("accel", g, tol=1e-12, zeta=0.99)
    assert_same(ref, got)
    assert (got.aux > 0).all() and (got.v > 0).all()


def test_zeta_preserves_ranking():
    g = generate_webgraph(WebGraphSpec(300, 3000, 0.5, seed=5))
    ref0, got0 = run("accel", g, tol=1e-12)
    ref1, got1 = run("accel", g, tol=1e-12, zeta=0.99)
    assert_same(ref0, got0)
    assert_same(ref1, got1)
    top0 = set(np.argsort(-got0.aux)[:10].tolist())
    top1 = set(np.argsort(-got1.aux)[:10].tolist())
    assert len(top0 & top1) >= 8


@pytest.mark.parametrize("zeta", [1.0, 0.95])
def test_reducible_graph_authority_sweep(zeta):
    """Two disjoint 2-cycles under ``authority_sweep`` + ``power_method``
    from two starts: equal to the reference run for run; without the fix
    the limits differ, with it both starts reach one positive vector."""
    g = Graph(4, np.array([0, 1, 2, 3]), np.array([1, 0, 3, 2]))
    re, pe = REdgeList.from_graph(g), EdgeList.from_graph(
        from_reference(g), "cpu")
    out = []
    for start in (np.array([0.9, 0.05, 0.025, 0.025]),
                  np.array([0.025, 0.025, 0.05, 0.9])):
        ref = r_power(r_authority_sweep(re, zeta=zeta), jnp.asarray(start),
                      tol=1e-13, max_iter=3000)
        got = power_method(authority_sweep(pe, zeta=zeta),
                           torch.from_numpy(start), tol=1e-13,
                           max_iter=3000)
        assert got.iters == ref.iters and got.converged == ref.converged
        assert np.abs(got.v - ref.v).sum() <= 1e-10
        assert np.abs(got.aux - ref.aux).sum() <= 1e-10
        out.append(got)
    if zeta == 1.0:
        assert np.abs(out[0].v - out[1].v).max() > 0.1
    else:
        np.testing.assert_allclose(out[0].v, out[1].v, atol=1e-8)
        assert (out[0].v > 0).all()


def test_authority_sweep_with_weights_matches_reference():
    """Eq. 6 with the acceleration weights, the sweep alone."""
    from repro.core.weights import accel_weights
    g = generate_webgraph(GRAPHS[1])
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    a = np.random.default_rng(0).random(g.n_nodes)
    ra, rt = r_authority_sweep(REdgeList.from_graph(g), jnp.asarray(ca),
                               jnp.asarray(ch))(jnp.asarray(a))
    pa, pt = authority_sweep(EdgeList.from_graph(from_reference(g), "cpu"),
                             torch.from_numpy(ca), torch.from_numpy(ch))(
        torch.from_numpy(a))
    np.testing.assert_allclose(pa.numpy(), np.asarray(ra), rtol=1e-13,
                               atol=1e-16)
    np.testing.assert_allclose(pt.numpy(), np.asarray(rt), rtol=1e-13,
                               atol=1e-16)


def test_power_method_hooks():
    """The extrapolation and checkpoint hooks see what the reference's
    see: numpy iterates, the same steps and residuals."""
    g = generate_webgraph(GRAPHS[0])
    calls = {}

    def hooks(tag):
        seen = calls.setdefault(tag, {"x": [], "ck": []})

        def extrapolator(hist):
            seen["x"].append(len(hist))
            return hist[-1] * 1.0

        def ckpt(step, v, residual):
            assert isinstance(v, np.ndarray)
            seen["ck"].append((step, residual))
        return dict(extrapolator=extrapolator, extrapolate_every=5,
                    checkpoint_cb=ckpt, checkpoint_every=4)

    ref = r_accel(g, tol=1e-12, **hooks("ref"))
    got = accel_hits(from_reference(g), tol=1e-12, device="cpu",
                     **hooks("port"))
    assert_same(ref, got)
    assert calls["ref"]["x"] == calls["port"]["x"]
    steps = lambda t: [s for s, _ in calls[t]["ck"]]  # noqa: E731
    assert steps("ref") == steps("port")
    np.testing.assert_allclose([r for _, r in calls["port"]["ck"]],
                               [r for _, r in calls["ref"]["ck"]], rtol=0,
                               atol=1e-14)


def test_uniform_start_and_device_default():
    x = uniform_start(10, 3, device="cpu")
    assert x.shape == (10, 3) and x.dtype == torch.float64
    assert np.array_equal(x.numpy(), np.asarray(r_uniform_start(10, 3)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            accel_hits(from_reference(generate_webgraph(GRAPHS[0])))
