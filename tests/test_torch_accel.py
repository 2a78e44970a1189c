"""Beyond-paper accelerations and the whole-graph kernel path in the port,
on the CPU, against the JAX package.

Mirrors ``tests/test_accelerations.py`` (extrapolation, dangling
reordering), ``tests/test_gauss_seidel.py``, the BlockRank half of
``tests/test_blockrank_kvquant.py`` and the ranking half of
``tests/test_system.py`` (the end-to-end pipeline, the engine against the
K1 sweep ``hits_sweep_bsr``, ``power_method_jit`` against the host loop).
Each case runs the reference and the port on the same inputs: the numpy
copies (extrapolators, Gauss-Seidel, the BlockRank bookkeeping) must be
exactly equal; f64 iterations equal iters and <= 1e-10 L1.

``hits_sweep_bsr`` is held to the reference's Pallas path in interpret
mode, computed in one subprocess that runs this file as a script with
``--xla_allow_excess_precision=false`` (as the port's K1 tests do): each
f32 sweep within 1e-6 L1.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import accel_hits as r_accel
from repro.core import aitken as r_aitken
from repro.core import hits_reordered as r_hits_reordered
from repro.core import qi_hits as r_qi
from repro.core import quadratic as r_quadratic
from repro.core import blockrank as r_blockrank
from repro.core.gauss_seidel import pagerank_gs as r_pagerank_gs
from repro.core.reordering import compact_nondangling as r_compact
from repro.graph import Graph as RGraph
from repro.graph import WebGraphSpec, generate_webgraph
from repro.graph import paper_dataset as r_paper_dataset
from repro_torch.core import (accel_hits, accel_weights, aitken, back_button,
                              blockrank, cosine, hits_reordered, pagerank,
                              qi_hits, quadratic, topk_overlap)
from repro_torch.core.engine import RankingEngine
from repro_torch.core.gauss_seidel import pagerank_gs
from repro_torch.core.hits import EdgeList, hits_sweep
from repro_torch.core.power import power_method, power_method_jit
from repro_torch.core.reordering import compact_nondangling
from repro_torch.graph import from_reference
from repro_torch.kernels import counters, hits_sweep_bsr, reset_counters

ROOT = Path(__file__).resolve().parents[1]


def l1(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def assert_same(ref, got, tol=1e-10):
    assert got.iters == ref.iters and got.converged == ref.converged
    assert got.v.shape == ref.v.shape
    assert l1(got.v, ref.v) <= tol
    if ref.aux is not None:
        assert l1(got.aux, ref.aux) <= tol


# ------------------------------------------------------ extrapolation


def histories(seed, v):
    rng = np.random.default_rng(seed)
    base = rng.random((300, v) if v > 1 else 300)
    return [base + 0.1 ** k * rng.random(base.shape) for k in range(1, 6)]


@pytest.mark.parametrize("v", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_extrapolators_equal_reference(seed, v):
    """Same numpy in, same numpy out (None where the reference gives up)."""
    hist = histories(seed, v)
    for ours, ref in ((aitken, r_aitken), (quadratic, r_quadratic)):
        for n in (2, 3, 4, 5):
            a, b = ours(hist[:n]), ref(hist[:n])
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and np.array_equal(a, b)


def test_quadratic_extrapolation_reduces_iterations():
    rg = generate_webgraph(WebGraphSpec(400, 2500, 0.85, seed=9))
    g = from_reference(rg)
    base = qi_hits(g, tol=1e-11, max_iter=4000, device="cpu")
    fast = qi_hits(g, tol=1e-11, max_iter=4000, extrapolator=quadratic,
                   extrapolate_every=6, device="cpu")
    assert fast.converged
    assert fast.iters <= base.iters
    np.testing.assert_allclose(fast.v, base.v, atol=1e-8)
    ref = r_qi(rg, tol=1e-11, max_iter=4000, extrapolator=r_quadratic,
               extrapolate_every=6)
    assert_same(ref, fast)


def test_aitken_preserves_fixed_point():
    rg = generate_webgraph(WebGraphSpec(200, 1500, 0.6, seed=10))
    g = from_reference(rg)
    base = qi_hits(g, tol=1e-11, device="cpu")
    fast = qi_hits(g, tol=1e-11, extrapolator=aitken, extrapolate_every=8,
                   device="cpu")
    assert fast.converged
    np.testing.assert_allclose(fast.v, base.v, atol=1e-8)
    ref = r_qi(rg, tol=1e-11, extrapolator=r_aitken, extrapolate_every=8)
    assert_same(ref, fast)


# ------------------------------------------------------ reordering


@pytest.mark.parametrize("accelerate", [False, True])
@pytest.mark.parametrize("name", ["wikipedia", "jobs", "opera"])
def test_reordered_matches_reference_and_full_hits(name, accelerate):
    rg = r_paper_dataset(name, scale=0.05)
    g = from_reference(rg)
    ref = r_hits_reordered(rg, accelerate=accelerate, tol=1e-11)
    got = hits_reordered(g, accelerate=accelerate, tol=1e-11, device="cpu")
    assert_same(ref, got)
    full = (accel_hits if accelerate else qi_hits)(g, tol=1e-11,
                                                   device="cpu")
    np.testing.assert_allclose(got.aux, full.aux, atol=1e-10)
    if not accelerate:
        np.testing.assert_allclose(got.v, full.v, atol=1e-10)


def test_reordered_vector_ops_shrink():
    """The compacted hub vector is N_nd-sized (the reordering win), and
    the compaction is the reference's."""
    rg = r_paper_dataset("opera", scale=0.05)
    cg = compact_nondangling(from_reference(rg), device="cpu")
    ref = r_compact(rg)
    assert cg.n_nd < 0.4 * cg.n  # opera has >90% dangling
    assert (cg.n, cg.n_nd) == (ref.n, ref.n_nd)
    assert np.array_equal(cg.nd_ids, ref.nd_ids)
    assert np.array_equal(cg.src_c.numpy(), np.asarray(ref.src_c))
    assert np.array_equal(cg.dst.numpy(), np.asarray(ref.dst))


# ------------------------------------------------------ Gauss-Seidel


@pytest.mark.parametrize("spec", [WebGraphSpec(300, 2200, 0.5, seed=23),
                                  WebGraphSpec(400, 3000, 0.7, seed=24)],
                         ids=["seed23", "seed24"])
def test_gs_equal_reference_and_power_pagerank(spec):
    rg = generate_webgraph(spec)
    g = from_reference(rg)
    p, k, res = pagerank_gs(g, tol=1e-12)
    rp, rk, rres = r_pagerank_gs(rg, tol=1e-12)
    assert k == rk and np.array_equal(p, rp) and np.array_equal(res, rres)
    p_pow = pagerank(g, tol=1e-12, device="cpu")
    np.testing.assert_allclose(p, p_pow.v / p_pow.v.sum(), atol=1e-8)


def test_gs_converges_in_fewer_sweeps():
    """Arasu et al.: GS 'clearly converges faster than the power method'."""
    g = from_reference(generate_webgraph(WebGraphSpec(400, 3000, 0.7,
                                                      seed=24)))
    p_pow = pagerank(g, tol=1e-10, device="cpu")
    _, k_gs, _ = pagerank_gs(g, tol=1e-10)
    assert k_gs < p_pow.iters


# ------------------------------------------------------ BlockRank


def blocky_graph(seed=0):
    """``tests/test_blockrank_kvquant.py``'s graph with strong
    intra-block structure (the BlockRank premise)."""
    rng = np.random.default_rng(seed)
    n, n_hosts = 600, 12
    blocks = r_blockrank.host_blocks(n, n_hosts, seed=seed)
    src, dst = [], []
    for _ in range(6000):
        u = rng.integers(0, n)
        if rng.random() < 0.97:  # intra-host link
            same = np.nonzero(blocks == blocks[u])[0]
            v = same[rng.integers(0, len(same))]
        else:
            v = rng.integers(0, n)
        if u != v:
            src.append(u)
            dst.append(v)
    return RGraph(n, np.array(src, np.int32),
                  np.array(dst, np.int32)).dedup(), blocks


@pytest.mark.parametrize("seed", [0, 3, 5])
def test_host_blocks_and_subgraph_equal_reference(seed):
    for n, hosts in ((600, 12), (1000, 40), (50, 60)):
        assert np.array_equal(blockrank.host_blocks(n, hosts, seed),
                              r_blockrank.host_blocks(n, hosts, seed))
    rg, blocks = blocky_graph(seed)
    nodes = np.nonzero(blocks == 1)[0]
    a = blockrank._subgraph(from_reference(rg), nodes)
    b = r_blockrank._subgraph(rg, nodes)
    assert a.n_nodes == b.n_nodes
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)


@pytest.mark.parametrize("accelerate", [True, False])
@pytest.mark.parametrize("seed", [0, 3])
def test_blockrank_matches_reference(seed, accelerate):
    rg, blocks = blocky_graph(seed)
    g = from_reference(rg)
    h0 = blockrank.block_warm_start(g, blocks, accelerate, device="cpu")
    ref_h0 = r_blockrank.block_warm_start(rg, blocks, accelerate)
    assert l1(h0, ref_h0) <= 1e-10
    got = blockrank.hits_blockrank(g, blocks, accelerate=accelerate,
                                   tol=1e-10, device="cpu")
    ref = r_blockrank.hits_blockrank(rg, blocks, accelerate=accelerate,
                                     tol=1e-10)
    assert_same(ref, got)


def test_blockrank_warm_start_reduces_sweeps():
    rg, blocks = blocky_graph()
    g = from_reference(rg)
    cold = accel_hits(g, tol=1e-10, device="cpu")
    warm = blockrank.hits_blockrank(g, blocks, accelerate=True, tol=1e-10,
                                    device="cpu")
    assert warm.converged
    assert warm.iters <= cold.iters
    np.testing.assert_allclose(warm.v, cold.v, atol=1e-8)


def test_blockrank_exactness_plain_hits():
    rg, blocks = blocky_graph(seed=3)
    g = from_reference(rg)
    cold = qi_hits(g, tol=1e-10, device="cpu")
    warm = blockrank.hits_blockrank(g, blocks, accelerate=False, tol=1e-10,
                                    device="cpu")
    np.testing.assert_allclose(warm.v, cold.v, atol=1e-8)


def test_block_warm_start_is_distribution():
    rg, blocks = blocky_graph(seed=5)
    h0 = blockrank.block_warm_start(from_reference(rg), blocks,
                                    device="cpu")
    assert np.isclose(h0.sum(), 1.0)
    assert (h0 >= 0).all()


# ------------------------------------------------------ the system


def test_end_to_end_ranking_pipeline():
    """Synthetic crawl -> back-button -> accelerated HITS -> the same
    ranking as exact QI-HITS on the same graph, in far fewer sweeps."""
    g = from_reference(r_paper_dataset("wikipedia", scale=0.1))
    bb = back_button(g)
    exact = qi_hits(bb, tol=1e-10, device="cpu")
    fast = accel_hits(bb, tol=1e-10, device="cpu")
    assert fast.iters < exact.iters
    assert cosine(fast.aux, exact.aux) > 0.55
    assert topk_overlap(fast.aux, exact.aux, 20) >= 0.5


def bsr_case(name, scale):
    rg = r_paper_dataset(name, scale=scale)
    g = from_reference(rg)
    return rg, g, accel_weights(g.indeg(), g.outdeg())


BSR_CASES = [("jobs", 0.05), ("wikipedia", 0.1)]


def compute_oracle(path):
    """The reference's ``hits_sweep_bsr`` (Pallas, interpret mode): every
    f32 iterate of ``iters + 5`` sweeps, per case."""
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from repro.core.engine import RankingEngine as RefEngine
    from repro.kernels import hits_sweep_bsr as r_hits_sweep_bsr
    out = {}
    for name, scale in BSR_CASES:
        rg, _, (ca, ch) = bsr_case(name, scale)
        r = RefEngine(rg, "accel", n_shards=4).run(tol=1e-11)
        sweep, _, _ = r_hits_sweep_bsr(rg, ca, ch, bs=128, interpret=True)
        h = jnp.full((rg.n_nodes,), 1.0 / rg.n_nodes, jnp.float32)
        hs, as_ = [], []
        for _ in range(r.iters + 5):
            h, a = sweep(h)
            hs.append(np.asarray(h))
            as_.append(np.asarray(a))
        out[f"{name}/h"] = np.stack(hs)
        out[f"{name}/a"] = np.stack(as_)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def bsr_oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("bsr_oracle") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("case", BSR_CASES, ids=lambda c: c[0])
def test_hits_sweep_bsr_matches_reference_kernel(bsr_oracle, case):
    """Every f32 sweep of the port's K1 path (plain version on the CPU)
    within 1e-6 L1 of the reference's Pallas path; the authority, which
    is not normalized (entries ~1), within 1e-6 of its own L1 norm (the
    two round f32 block products differently, by an ulp here and there)."""
    name, scale = case
    _, g, (ca, ch) = bsr_case(name, scale)
    sweep, lt, lf = hits_sweep_bsr(g, ca, ch, bs=128, device="cpu")
    assert lt.cols.dtype == torch.int32 and lt.ptr.shape == (g.n_nodes + 1,)
    hs, as_ = bsr_oracle[f"{name}/h"], bsr_oracle[f"{name}/a"]
    h = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float32)
    reset_counters()
    for k in range(len(hs)):
        h, a = sweep(h)
        assert h.dtype == torch.float32 and h.shape == (g.n_nodes,)
        assert l1(h.numpy(), hs[k]) <= 1e-6, k
        assert l1(a.numpy(), as_[k]) <= 1e-6 * np.abs(as_[k]).sum(), k
    # CPU tensors: the plain version
    assert counters.bsr_spmm == counters.k1_links == 0


@pytest.mark.parametrize("case", BSR_CASES, ids=lambda c: c[0])
def test_engine_with_kernel_path(case):
    """``tests/test_system.py``: the RankingEngine's hub == the K1 sweep's
    fixed point after iters + 5 sweeps (max abs < 1e-4)."""
    name, scale = case
    _, g, (ca, ch) = bsr_case(name, scale)
    r = RankingEngine(g, "accel", n_shards=4, device="cpu").run(tol=1e-11)
    sweep, _, _ = hits_sweep_bsr(g, ca, ch, bs=128, device="cpu")
    h = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float32)
    for _ in range(r.iters + 5):
        h, _ = sweep(h)
    assert np.abs(h.double().numpy() - r.hub).max() < 1e-4


def test_hits_sweep_bsr_multicolumn_and_shapes():
    """(N, V) iterates normalize per column; each operator holds one
    entry a link (``ptr[-1]`` is the graph's link count), Lᵀ's row i the
    sources of page i's in-links and L's the targets of its out-links,
    each row's by column, whatever ``bs`` says."""
    _, g, (ca, ch) = bsr_case("jobs", 0.05)
    for bs in (16, 128):
        sweep, lt, lf = hits_sweep_bsr(g, ca, ch, bs=bs, dtype="float64",
                                       device="cpu")
        for op, rows, cols in ((lt, g.dst, g.src), (lf, g.src, g.dst)):
            assert op.ptr.shape == (g.n_nodes + 1,)
            assert int(op.ptr[-1]) == op.cols.numel() == g.n_edges
            order = np.lexsort((cols, rows))
            np.testing.assert_array_equal(op.cols.numpy(), cols[order])
            np.testing.assert_array_equal(
                np.diff(op.ptr.numpy()), np.bincount(rows, minlength=g.n_nodes))
    h1 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64)
    h3 = h1[:, None].repeat(1, 3).contiguous()
    for _ in range(4):
        h1, _ = sweep(h1)
        h3, _ = sweep(h3)
    np.testing.assert_allclose(h3.sum(dim=0).numpy(), 1.0, atol=1e-12)
    for j in range(3):  # the L1 norm of an (N, 3) column adds in another order
        np.testing.assert_allclose(h3[:, j].numpy(), h1.numpy(), rtol=1e-13,
                                   atol=0)


def link_case(case):
    """(graph, V, per-column cin) of a link-form case: a crawl with an
    empty row, one page holding most links (a long row of the kernel), a
    repeated link, or three columns with per-column diagonals."""
    rng = np.random.default_rng(11)
    n, e = 300, 2400
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    if case == "empty row":
        keep = (src != 7) & (dst != 7)
        src, dst = src[keep], dst[keep]
    elif case == "hub":
        hub = rng.random(e) < 0.7
        dst[hub], src[hub & (src == 5)] = 5, 6
    elif case == "repeated link":
        src, dst = np.append(src, [src[0]] * 2), np.append(dst, [dst[0]] * 2)
    from repro_torch.graph.structure import Graph
    return Graph(n, src, dst), (3 if case == "3 columns" else 1), \
        case == "3 columns"


def kernel_order_sum(op, x, cin):
    """The link kernel's sum written out as loops: lane l of a row's w
    lanes (``op.lanes``, 256 for a long row) adds links l, l + w, ... from
    0; an xor butterfly adds a warp's lanes; a long row's warps are added
    in order."""
    ptr, cols = op.ptr.numpy(), op.cols.numpy()
    terms = (x * cin).double().numpy()[cols]
    y = np.zeros((len(ptr) - 1, x.shape[1]))
    for i in range(len(ptr) - 1):
        seg = terms[ptr[i]:ptr[i + 1]]
        w = 256 if len(seg) > 32 * op.lanes else op.lanes
        for c in range(x.shape[1]):
            part = np.zeros(w)
            for lane in range(w):
                for t in seg[lane::w, c]:
                    part[lane] += t
            for warp in range(0, w, 32) if w > 32 else [0]:
                p = part[warp:warp + min(w, 32)]
                o = len(p) // 2
                while o:
                    p = p + p[np.arange(len(p)) ^ o]
                    o //= 2
                y[i, c] += p[0]
    return torch.tensor(y).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_link_form_plain_sums_in_the_kernel_order(dtype):
    """The plain version of K1's link form adds each row's terms in the
    CUDA kernel's order, so the card's tests hold the kernel to it bit for
    bit: equal to that order written out as loops, with a long row (a hub
    of a CTA's 256 lanes), empty rows and two columns."""
    from repro_torch.kernels import link_operand, links_scaled_matvec_plain
    from repro_torch.graph.structure import Graph
    rng = np.random.default_rng(2)
    n, e = 120, 1500
    src, dst = rng.integers(0, n // 2, e), rng.integers(0, n, e)
    dst[:700] = 9
    g = Graph(n, src, dst)
    dt = getattr(torch, dtype)
    x = torch.tensor(rng.random((n, 2)), dtype=dt)
    cin = torch.tensor(rng.random((n, 1)), dtype=dt)
    for transpose in (True, False):
        op = link_operand(g, transpose=transpose, device="cpu")
        assert (9 in op.long_rows.tolist()) == transpose
        assert torch.equal(links_scaled_matvec_plain(op, x, cin),
                           kernel_order_sum(op, x, cin))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", ["empty row", "hub", "repeated link",
                                  "3 columns"])
def test_link_form_matches_blocked_k1(case, dtype):
    """K1's link form (plain version) against the blocked K1's plain
    version over the same graph, both operators: f64 within 1e-13 of the
    largest entry (the same terms summed in other orders), f32 within
    1e-6 (the blocked K1 rounds each block's product to f32, the link
    form rounds each row's f64 sum once)."""
    from repro_torch.kernels import DeviceBSR, bsr_matvec, link_operand
    from repro_torch.kernels import links_scaled_matvec
    g, v, per_column = link_case(case)
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.random((g.n_nodes, v)), dtype=dt)
    cin = torch.tensor(rng.random((g.n_nodes, v if per_column else 1)),
                       dtype=dt)
    for transpose in (True, False):
        links = link_operand(g, transpose=transpose, device="cpu")
        blocked = DeviceBSR.build(g, 128, transpose=transpose,
                                  dtype=dtype, device="cpu")
        got = links_scaled_matvec(links, x, cin)
        want = bsr_matvec(blocked, x, cin)
        assert got.dtype == dt and got.shape == (g.n_nodes, v)
        err = float((got.double() - want.double()).abs().max())
        scale = float(want.double().abs().max())
        assert err <= (1e-13 if dtype == "float64" else 1e-6) * scale
        if case == "empty row":
            assert not got[7].any()
        if case == "hub" and transpose:
            assert links.long_rows.tolist() == [5]
            assert np.sum(g.dst == 5) > 32 * links.lanes
        if case == "repeated link":
            assert int(links.ptr[-1]) == g.n_edges


# ------------------------------------------------------ power_method_jit


@pytest.mark.parametrize("check_every", [1, 4])
def test_power_method_jit_matches_host_loop(check_every):
    """``tests/test_system.py``'s case, on the port (its plain CPU loop),
    plus the reference's own ``power_method_jit`` on the same sweep: equal
    iters, 1e-10 L1 on v and aux, the same delta to 1e-14."""
    import jax.numpy as jnp
    from repro.core.hits import EdgeList as REdgeList
    from repro.core.hits import hits_sweep as r_hits_sweep
    from repro.core.power import power_method_jit as r_power_method_jit
    rg = r_paper_dataset("opera", scale=0.03)
    g = from_reference(rg)
    sweep = hits_sweep(EdgeList.from_graph(g, "cpu"))
    h0 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64)
    host = power_method(sweep, h0, tol=1e-11)
    v, aux, iters, delta = power_method_jit(sweep, h0, tol=1e-11,
                                            max_iter=2000,
                                            check_every=check_every)
    assert float(delta) <= 1e-11
    np.testing.assert_allclose(v.numpy(), host.v, atol=1e-9)
    if check_every == 1:
        assert int(iters) == host.iters
    rv, raux, riters, rdelta = r_power_method_jit(
        r_hits_sweep(REdgeList.from_graph(rg)),
        jnp.full((rg.n_nodes,), 1.0 / rg.n_nodes, jnp.float64), tol=1e-11,
        max_iter=2000, check_every=check_every)
    assert int(iters) == int(riters)
    assert l1(v.numpy(), rv) <= 1e-10 and l1(aux.numpy(), raux) <= 1e-10
    assert abs(float(delta) - float(rdelta)) <= 1e-14
    assert v.dtype == torch.float64 and delta.dtype == torch.float64


@pytest.mark.parametrize("max_iter", [0, 3])
def test_power_method_jit_max_iter(max_iter):
    """max_iter 0 runs no sweep (aux zeros, delta inf); a budget that
    ends the loop stops at k >= max_iter."""
    g = from_reference(generate_webgraph(WebGraphSpec(150, 900, 0.5,
                                                      seed=1)))
    sweep = hits_sweep(EdgeList.from_graph(g, "cpu"))
    h0 = torch.full((g.n_nodes, 2), 1.0 / g.n_nodes, dtype=torch.float64)
    v, aux, iters, delta = power_method_jit(sweep, h0, tol=1e-14,
                                            max_iter=max_iter, check_every=2)
    if max_iter == 0:
        assert int(iters) == 0 and torch.equal(v, h0)
        assert not aux.any() and float(delta) == float("inf")
    else:
        assert int(iters) == 4 and float(delta) > 1e-14
        host = power_method(sweep, h0, tol=0.0, max_iter=4)
        np.testing.assert_allclose(v.numpy(), host.v, atol=1e-15)
    with pytest.raises(ValueError):
        power_method_jit(sweep, h0, check_every=0)


if __name__ == "__main__":
    compute_oracle(sys.argv[1])
