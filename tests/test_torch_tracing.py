"""The port's span recorder (``repro_torch.tracing``) and the spans the
whole-crawl path records: off it records nothing, on it nests spans per
thread, keeps at most ``LIMIT``, and ``power_method`` over
``hits_sweep_bsr`` records one span tree a ranking."""
from __future__ import annotations

import threading

import numpy as np
import pytest

from repro_torch import tracing
from repro_torch.core.power import power_method
from repro_torch.core.weights import accel_weights
from repro_torch.graph.structure import Graph
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _recorder_off():
    """Each test starts and ends with the recorder off and empty."""
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def names(spans):
    return [sp[0] for sp in spans]


def test_off_span_is_one_shared_noop_and_records_nothing():
    a, b = tracing.span("a"), tracing.span("b")
    assert a is b
    with tracing.span("a"):
        with tracing.span("b"):
            pass
    rec = tracing.record()
    assert rec["spans"] == [] and rec["dropped"] == 0
    assert "bsr_spmm_bytes" in rec["counters"]


def test_nesting_sets_parent():
    tracing.enable()
    with tracing.span("outer"):
        with tracing.span("inner"):
            with tracing.span("leaf"):
                pass
        with tracing.span("second"):
            pass
    with tracing.span("after"):
        pass
    spans = tracing.record()["spans"]
    assert names(spans) == ["outer", "inner", "leaf", "second", "after"]
    assert [sp[1] for sp in spans] == [-1, 0, 1, 0, -1]
    assert len({sp[2] for sp in spans}) == 1
    for _n, _p, _th, t0, t1 in spans:
        assert t0 <= t1
    assert spans[0][3] <= spans[1][3] and spans[1][4] <= spans[0][4]


def test_parents_stay_separate_across_threads():
    tracing.enable()
    both_in = threading.Barrier(2, timeout=30)

    def work(tag):
        with tracing.span(f"outer.{tag}"):
            both_in.wait()  # both outers are open before either inner
            with tracing.span(f"inner.{tag}"):
                both_in.wait()

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = tracing.record()["spans"]
    assert sorted(names(spans)) == ["inner.a", "inner.b", "outer.a",
                                    "outer.b"]
    for tag in "ab":
        inner = next(sp for sp in spans if sp[0] == f"inner.{tag}")
        outer = spans[inner[1]]
        assert outer[0] == f"outer.{tag}" and outer[2] == inner[2]
        assert next(sp for sp in spans if sp[0] == f"outer.{tag}")[1] == -1
    threads_of = {sp[0]: sp[2] for sp in spans}
    assert threads_of["outer.a"] != threads_of["outer.b"]


def test_a_torch_without_the_fast_range_falls_back(monkeypatch):
    """The fast range is private to torch: without it the module still
    imports, and a live span opens ``record_function`` instead."""
    import torch
    monkeypatch.delattr(torch._C._profiler, "_RecordFunctionFast",
                        raising=False)
    tracing.enable()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.span("fallback.span"):
            torch.ones(4).sum()
    assert names(tracing.record()["spans"]) == ["fallback.span"]
    assert "fallback.span" in {e.name for e in prof.events()}


def test_limit_counts_dropped(monkeypatch):
    monkeypatch.setattr(tracing, "LIMIT", 3)
    tracing.enable()
    with tracing.span("kept"):
        for _ in range(4):
            with tracing.span("more"):
                pass
    rec = tracing.record()
    assert names(rec["spans"]) == ["kept", "more", "more"]
    assert rec["dropped"] == 2


def test_reset_empties_the_spans():
    tracing.enable()
    for _ in range(3):
        with tracing.span("x"):
            pass
    assert len(tracing.record()["spans"]) == 3
    tracing.reset()
    rec = tracing.record()
    assert rec["spans"] == [] and rec["dropped"] == 0
    with tracing.span("y"):
        pass
    assert [(sp[0], sp[1]) for sp in tracing.record()["spans"]] == [("y", -1)]


def test_a_span_open_across_reset_parents_nothing_after_it():
    tracing.enable()
    with tracing.span("old"):
        tracing.reset()
        with tracing.span("new"):
            pass
    assert [(sp[0], sp[1]) for sp in tracing.record()["spans"]] == \
        [("new", -1)]


def crawl(seed=3, n=300, e=2400):
    rng = np.random.default_rng(seed)
    g = Graph(n, rng.integers(0, n, e), rng.integers(0, n, e))
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    return g, ca, ch


def test_power_method_over_hits_sweep_bsr_records_its_span_tree():
    """The build records ``ops.fit`` once and ``bsr.blocks``,
    ``bsr.stage``, ``bsr.h2d`` once an operator; a ranking records one
    ``power.ranking`` holding, each sweep, ``power.sweep`` (two ``k1``
    under it) then ``power.residual``, and last ``power.readback``."""
    import torch
    g, ca, ch = crawl()
    tracing.enable()
    sweep, _lt, _l = ops.hits_sweep_bsr(g, ca, ch, bs=32, dtype="float64",
                                        device="cpu")
    built = tracing.record()["spans"]
    assert names(built) == ["ops.fit"] + ["bsr.blocks", "bsr.stage",
                                          "bsr.h2d"] * 2
    assert all(sp[1] == -1 for sp in built)
    tracing.reset()
    h0 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64)
    r = power_method(sweep, h0, tol=1e-9, max_iter=200)
    assert r.converged and r.iters > 2
    spans = tracing.record()["spans"]
    top = [i for i, sp in enumerate(spans) if sp[1] == -1]
    assert names(spans[i] for i in top) == ["power.ranking"]
    kids = [i for i, sp in enumerate(spans) if sp[1] == top[0]]
    assert names(spans[i] for i in kids) == \
        ["power.sweep", "power.residual"] * r.iters + ["power.readback"]
    for i in kids:
        under = [sp for sp in spans if sp[1] == i]
        assert names(under) == (["k1", "k1"] if spans[i][0] == "power.sweep"
                                else [])
    assert len(spans) == 1 + 4 * r.iters + 1


def test_the_spans_change_no_answer():
    """The same ranking with the recorder off and on gives the same
    bits."""
    import torch
    g, ca, ch = crawl(seed=4)
    out = []
    for on in (False, True):
        (tracing.enable if on else tracing.disable)()
        sweep, _lt, _l = ops.hits_sweep_bsr(g, ca, ch, bs=32,
                                            dtype="float64", device="cpu")
        h0 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64)
        out.append(power_method(sweep, h0, tol=1e-9, max_iter=200))
    assert np.array_equal(out[0].v, out[1].v)
    assert np.array_equal(out[0].aux, out[1].aux)
    assert out[0].iters == out[1].iters
