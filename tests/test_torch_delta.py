"""Live edge deltas in the port (``serve/delta.py``,
``RankService.apply_edge_delta``, ``SweepBackend.patch`` and the
weight-blind topology index) against the JAX package's service, on the
CPU.

Each test runs one scenario of ``tests/test_serve_delta.py`` on a
reference service and on the port's (``device="cpu"``) built over the
same graph, and holds the port to the reference: per query 1e-10 L1 on
authority and hub, equal iters, status and node set; equal delta
counters (patched per backend, replanned, invalidated), plan misses and
delta summaries. The scenario's own assertions from the reference test
hold too; the spill cases (restart fencing, survivors re-spilled, a
cleared cache staying cleared on disk) also hold ``data_generation`` and
the ``service.spill.*`` counters to the reference's. The sharded case
waits with its module.
"""
import numpy as np
import pytest

from repro.graph import Graph as RGraph
from repro.graph import WebGraphSpec, generate_webgraph
from repro.serve import RankService as RefService
from repro.serve import RankServiceConfig as RefConfig
from repro.serve import delta as rdelta
from repro_torch.graph import from_reference
from repro_torch.serve import RankService, RankServiceConfig
from repro_torch.serve import delta as pdelta

TOL = 1e-10


@pytest.fixture(scope="module")
def g():
    return generate_webgraph(WebGraphSpec(1500, 12000, 0.4, seed=7))


def make(graph, port, backend="dense", **kw):
    if port:
        return RankService(from_reference(graph), RankServiceConfig(
            device="cpu", v_max=4, tol=TOL, backend=backend, **kw))
    return RefService(graph, RefConfig(v_max=4, tol=TOL, backend=backend,
                                       **kw))


def union_edge(svc, roots):
    """A (src, dst) global edge inside this root set's union subgraph."""
    fs = svc.extractor.extract(np.asarray(roots))
    return (int(fs.nodes[fs.graph.src[0]]), int(fs.nodes[fs.graph.dst[0]]))


def counters(svc):
    snap = svc.telemetry_snapshot()
    return {"patched": snap["service.delta.patched"],
            "replanned": snap["service.delta.replanned"],
            "invalidated": snap["service.delta.invalidated"],
            "swaps": snap["service.delta.swap_ms"]["count"],
            "plan_misses": svc.stats["plan_misses"],
            "plan_hits": svc.stats["plan_hits"]}


def summary(s):
    return {k: v for k, v in s.items() if k != "swap_ms"}


def both(scenario, graph, **kw):
    """Run ``scenario(svc) -> (results, extra)`` on a reference and a port
    service; returns ((results, extra, counters) per side)."""
    out = []
    for port in (False, True):
        svc = make(graph, port, **kw)
        results, extra = scenario(svc)
        out.append((results, extra, counters(svc)))
    return out


def assert_matches(ref, got):
    (rr, rx, rc), (pr, px, pc) = ref, got
    assert rc == pc, (rc, pc)
    assert rx == px, (rx, px)
    assert len(rr) == len(pr)
    for r, p in zip(rr, pr):
        assert np.array_equal(r.nodes, p.nodes)
        assert p.status == r.status and p.iters == r.iters, \
            (p.status, p.iters, r.status, r.iters)
        assert np.abs(p.authority - r.authority).sum() <= TOL
        assert np.abs(p.hub - r.hub).sum() <= TOL


# ------------------------------------------------ weight-only: patch path


@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_weight_delta_patches_plan(g, backend):
    """A reweight-only delta invalidates the touched entry and patches
    the surviving plan (patched >= 1, no new plan miss)."""
    roots = np.array([1, 2, 3])

    def scenario(svc):
        first = svc.rank([roots])
        u, v = union_edge(svc, roots)
        misses = svc.stats["plan_misses"]
        summ = svc.apply_edge_delta(reweights=[(u, v, 2.0)])
        r = svc.rank([roots])
        assert summ["structural"] is False and summ["invalidated"] >= 1
        assert r[0].status != "hit"
        assert svc.stats["plan_misses"] == misses
        return first + r, summary(summ)

    ref, got = both(scenario, g, backend=backend)
    assert got[2]["patched"][backend] >= 1
    assert_matches(ref, got)


def test_patch_vs_replan_parity(g):
    """The patched dense plan serves what a plan-cache-disabled service
    (every batch rebuilt) serves after the same delta."""
    roots = np.array([7, 8, 9])

    def patched(svc):
        svc.rank([roots])
        u, v = union_edge(svc, roots)
        svc.apply_edge_delta(reweights=[(u, v, 0.5)])
        return svc.rank([roots]), None

    def rebuilt(svc):
        u, v = union_edge(svc, roots)
        svc.apply_edge_delta(reweights=[(u, v, 0.5)])
        return svc.rank([roots]), None

    ref, got = both(patched, g)
    assert got[2]["patched"]["dense"] >= 1
    assert_matches(ref, got)
    ref_r, got_r = both(rebuilt, g, plan_cache_size=0)
    assert_matches(ref_r, got_r)
    assert np.abs(got[0][0].authority - got_r[0][0].authority).sum() <= TOL


# ------------------------------------------------ structural deltas


def test_structural_add_remove(g):
    """Adds at weight 1.0 and removes rank like a service built on the
    post-delta edge list."""
    roots = np.array([10, 11, 12])
    made = {}

    def scenario(svc):
        svc.rank([roots])
        u, v = union_edge(svc, roots)
        add = (int(roots[0]), (v + 1) % g.n_nodes)
        made["edges"] = (u, v, add)
        summ = svc.apply_edge_delta(adds=[add], removes=[(u, v)])
        assert summ["structural"] is True
        return svc.rank([roots]), summary(summ)

    ref, got = both(scenario, g)
    assert_matches(ref, got)
    u, v, add = made["edges"]
    keep = ~((np.asarray(g.src) == u) & (np.asarray(g.dst) == v))
    g2 = RGraph(g.n_nodes, np.concatenate([g.src[keep], [add[0]]]),
                np.concatenate([g.dst[keep], [add[1]]]))
    plain = make(g2, True).rank([roots])[0]
    assert np.abs(plain.authority - got[0][0].authority).sum() <= TOL


def test_untouched_entries_survive_structural_delta(g):
    """A structural delta outside a query's union leaves its cached result
    and plan serving."""
    roots = np.array([20, 21])

    def scenario(svc):
        svc.rank([roots])
        fs = svc.extractor.extract(roots)
        outside = np.setdiff1d(np.arange(g.n_nodes), fs.nodes)[:2]
        misses = svc.stats["plan_misses"]
        summ = svc.apply_edge_delta(adds=[(int(outside[0]),
                                           int(outside[1]))])
        r = svc.rank([roots])
        assert summ["invalidated"] == 0 and r[0].status == "hit"
        assert svc.stats["plan_misses"] == misses
        return r, summary(summ)

    assert_matches(*both(scenario, g))


def test_add_of_existing_pair_is_reweight(g):
    """Re-adding a live pair with a new weight equals reweighting it."""
    roots = np.array([30, 31, 32])
    out = {}
    for how in ("adds", "reweights"):
        def scenario(svc):
            u, v = union_edge(svc, roots)
            summ = svc.apply_edge_delta(**{how: [(u, v, 2.5)]})
            return svc.rank([roots]), summary(summ)
        out[how] = both(scenario, g)
        assert_matches(*out[how])
    a, r = out["adds"][1][0][0], out["reweights"][1][0][0]
    assert np.abs(a.authority - r.authority).sum() <= TOL


# ------------------------------------------------ warm-start carryover


def test_warm_start_carries_over_a_delta(g):
    """After a small reweight the refresh starts from the pre-delta fixed
    point (status "warm") and takes fewer sweeps than the cold build."""
    roots = np.array([40, 41, 42])

    def scenario(svc):
        cold = svc.rank([roots])
        u, v = union_edge(svc, roots)
        svc.apply_edge_delta(reweights=[(u, v, 1.05)])
        warm = svc.rank([roots])
        assert cold[0].status == "cold" and warm[0].status == "warm"
        assert 0 < warm[0].iters < cold[0].iters
        return cold + warm, None

    assert_matches(*both(scenario, g))


def test_delta_sequence_on_overlapping_batches(g):
    """Two batches of four overlapping queries on both backends, then a
    weight-only delta of several union edges, a structural delta, and a
    second reweight: every served batch, summary and counter matches."""
    rng = np.random.default_rng(3)
    qs = [rng.choice(g.n_nodes, size=4, replace=False) for _ in range(8)]

    def scenario(svc):
        out, summ = svc.rank(qs), []
        fs = svc.extractor.extract_union([svc.extractor.extract(q)
                                          for q in qs[:4]])
        pick = np.random.default_rng(4).choice(fs.graph.n_edges, 12,
                                               replace=False)
        pairs = [(int(fs.nodes[fs.graph.src[i]]),
                  int(fs.nodes[fs.graph.dst[i]])) for i in pick]
        summ.append(svc.apply_edge_delta(
            reweights=[(s, d, 2.0) for s, d in pairs[:8]]))
        out += svc.rank(qs)
        summ.append(svc.apply_edge_delta(removes=pairs[8:10],
                                         adds=[(pairs[10][1], pairs[11][0])]))
        out += svc.rank(qs)
        summ.append(svc.apply_edge_delta(reweights=[(*pairs[0], 0.25)]))
        out += svc.rank(qs, refresh=True)
        return out, [summary(s) for s in summ]

    for backend in ("dense", "bsr"):
        ref, got = both(scenario, g, backend=backend)
        assert_matches(ref, got)
        assert got[2]["patched"][backend] >= 1


# ------------------------------------------------ spill generation fence


def spill_counters(svc):
    return {k: svc.stats[k] for k in ("spill_writes", "spill_hits",
                                      "spill_restored", "plan_spilled",
                                      "plan_restored")}


def both_spilled(scenario, graph, tmp_path, **kw):
    """``both`` for scenarios that restart: ``scenario(new) -> (results,
    extra)``, where ``new(**more)`` makes a service of this side on its
    own spill dir; the last service made reports the counters."""
    out = []
    for port in (False, True):
        made = []

        def new(**more):
            made.append(make(graph, port, spill_dir=str(
                tmp_path / ("port" if port else "ref")), **{**kw, **more}))
            return made[-1]

        results, extra = scenario(new)
        out.append((results, extra, {**counters(made[-1]),
                                     **spill_counters(made[-1])}))
    return out


def test_restart_after_delta_never_serves_predelta_vectors(g, tmp_path):
    """Spilled pre-delta vectors are generation-fenced: a restart on the
    same spill dir does not resurrect them, and the refreshed answer
    matches the reference's."""
    roots = np.array([50, 51, 52])

    def scenario(new):
        svc = new(spill_policy="all")
        first = svc.rank([roots])
        svc.flush_spill()
        assert svc.stats["spill_writes"] >= 1
        u, v = union_edge(svc, roots)
        summ = svc.apply_edge_delta(reweights=[(u, v, 2.0)])
        assert summ["data_generation"] == 1
        svc2 = new(spill_policy="all")
        assert svc2.stats["spill_restored"] == 0
        summ2 = svc2.apply_edge_delta(reweights=[(u, v, 2.0)])
        r = svc2.rank([roots])
        assert r[0].status == "cold" and svc2.stats["spill_hits"] == 0
        return first + r, [summary(summ), summary(summ2)]

    assert_matches(*both_spilled(scenario, g, tmp_path))


def test_delta_respills_survivors_under_new_generation(g, tmp_path):
    """Entries the delta did not touch are re-spilled under the new
    generation, so a restart still serves them from disk."""
    touched_roots, safe_roots = np.array([60, 61]), np.array([62, 63])

    def scenario(new):
        svc = new(spill_policy="all")
        first = svc.rank([touched_roots, safe_roots])
        svc.flush_spill()
        fs_t = svc.extractor.extract(touched_roots)
        safe = set(svc.extractor.extract(safe_roots).nodes.tolist())
        edge = next(((int(fs_t.nodes[s]), int(fs_t.nodes[d]))
                     for s, d in zip(fs_t.graph.src, fs_t.graph.dst)
                     if int(fs_t.nodes[s]) not in safe
                     and int(fs_t.nodes[d]) not in safe), None)
        assert edge is not None, "no union edge isolable from the safe query"
        summ = svc.apply_edge_delta(reweights=[(edge[0], edge[1], 2.0)])
        svc2 = new(spill_policy="all")
        assert svc2.stats["spill_restored"] == 1  # survivor only, new gen
        r = svc2.rank([safe_roots])
        assert r[0].status == "hit"
        assert np.array_equal(r[0].authority, first[1].authority)
        return first + r, summary(summ)

    assert_matches(*both_spilled(scenario, g, tmp_path))


def test_clear_result_cache_clears_disk_fallback_too(g, tmp_path):
    """clear_result_cache() bumps the spill generation: cleared state
    stays cleared across the disk fallback and a restart."""
    roots = np.array([70, 71, 72])

    def scenario(new):
        svc = new(spill_policy="all")
        first = svc.rank([roots])
        svc.flush_spill()
        hit = svc.rank([roots])
        assert hit[0].status == "hit"
        svc.clear_result_cache()
        svc2 = new(spill_policy="all")
        assert svc2.stats["spill_restored"] == 0
        r = svc.rank([roots])
        assert r[0].status == "cold" and svc.stats["spill_hits"] == 0
        new(spill_policy="all")  # a third restart reports the counters
        return first + hit + r, svc._spill.data_generation

    assert_matches(*both_spilled(scenario, g, tmp_path))


# ------------------------------------------------ roots and validation


def test_duplicate_roots_rank_identically_to_deduped(g):
    def scenario(svc):
        dup = svc.rank([np.array([80, 80, 81])])
        ded = svc.rank([np.array([80, 81])])
        assert ded[0].status == "hit"
        assert (dup[0].roots == np.array([80, 81])).all()
        assert np.array_equal(dup[0].authority, ded[0].authority)
        return dup + ded, None

    assert_matches(*both(scenario, g))


def test_delta_validation_errors(g):
    """The same changesets raise the same errors, and none mutates the
    service."""
    for port in (False, True):
        svc = make(g, port)
        u, v = union_edge(svc, np.array([1, 2]))
        absent = (0, 0) if not ((g.src == 0) & (g.dst == 0)).any() \
            else (0, 1)
        for kw, match in (
                ({"removes": [absent]}, "not in the graph"),
                ({"reweights": [(absent[0], absent[1], 2.0)]},
                 "not in the graph"),
                ({"reweights": [(u, v, 0.0)]}, "finite and nonzero"),
                ({"adds": [(u, v, float("nan"))]}, "finite and nonzero"),
                ({"removes": [(u, g.n_nodes)]}, "outside"),
                ({"reweights": [(u, v)]}, "want")):
            with pytest.raises(ValueError, match=match):
                svc.apply_edge_delta(**kw)
        assert counters(svc)["swaps"] == 0


def test_empty_delta_is_a_noop(g):
    roots = np.array([90, 91])

    def scenario(svc):
        svc.rank([roots])
        summ = svc.apply_edge_delta()
        assert summ == {"structural": False, "invalidated": 0,
                        "touched_nodes": 0, "data_generation": None,
                        "swap_ms": 0.0}
        r = svc.rank([roots])
        assert r[0].status == "hit"
        return r, summ

    assert_matches(*both(scenario, g))


def test_apply_to_graph_matches_reference():
    """The reference test's small case (pure, last add wins), then a
    random changeset on a larger graph: edges, weight tables, touched
    nodes and looked-up weights equal the reference's."""
    g = RGraph(4, np.array([0, 1, 2]), np.array([1, 2, 3]))
    kw = dict(adds=[(0, 3, 2.0), (0, 3, 5.0)], removes=[(2, 3)], n_nodes=4)
    rd, pd = rdelta.EdgeDelta.normalize(**kw), pdelta.EdgeDelta.normalize(
        **kw)
    assert pd.structural and rd.structural
    assert np.array_equal(pd.touched_nodes(), np.array([0, 2, 3]))
    g2, (keys, vals) = pdelta.apply_to_graph(from_reference(g), None, pd)
    assert g.n_edges == 3 and g2.n_edges == 3  # pure
    assert set(zip(g2.src.tolist(), g2.dst.tolist())) == {(0, 1), (1, 2),
                                                           (0, 3)}
    w = pdelta.lookup_weights((keys, vals), 4, g2.src, g2.dst)
    got = dict(zip(zip(g2.src.tolist(), g2.dst.tolist()), w.tolist()))
    assert got[(0, 3)] == 5.0 and got[(0, 1)] == 1.0

    big = generate_webgraph(WebGraphSpec(300, 2000, 0.3, seed=5))
    rng = np.random.default_rng(6)
    pairs = np.stack([big.src, big.dst], 1)[rng.choice(big.n_edges, 30,
                                                       replace=False)]
    kw = dict(adds=[(int(s), int(d), 3.0) for s, d in
                    rng.integers(0, 300, (10, 2))] + [(*map(int, pairs[0]),
                                                       4.0)],
              removes=[tuple(map(int, p)) for p in pairs[1:10]],
              reweights=[(int(s), int(d), float(w)) for (s, d), w in
                         zip(pairs[10:], rng.random(20) + 0.5)],
              n_nodes=300)
    rd, pd = rdelta.EdgeDelta.normalize(**kw), pdelta.EdgeDelta.normalize(
        **kw)
    assert np.array_equal(rd.touched_nodes(), pd.touched_nodes())
    rg2, rtab = rdelta.apply_to_graph(big, None, rd)
    pg2, ptab = pdelta.apply_to_graph(from_reference(big), None, pd)
    for a, b in ((rg2.src, pg2.src), (rg2.dst, pg2.dst), (rtab[0], ptab[0]),
                 (rtab[1], ptab[1])):
        assert np.array_equal(a, b)
    assert np.array_equal(
        rdelta.lookup_weights(rtab, 300, rg2.src, rg2.dst),
        pdelta.lookup_weights(ptab, 300, pg2.src, pg2.dst))
