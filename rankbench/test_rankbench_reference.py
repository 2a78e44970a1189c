"""The plain reference against the port on the CPU at a small scale: one
whole-crawl ranking and the acceleration weights; and the reference's
own files import nothing of the program."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import numpy as np
import pytest

from rankbench import reference, webgraph

ROOT = Path(__file__).resolve().parents[1]


def _cfg(name):
    return json.loads((ROOT / f"rankbench/configs/{name}.json").read_text())


@pytest.mark.parametrize("name", ["britannica-bb", "yahoo-bb"])
def test_crawl_ranking_matches_the_port(name):
    import torch
    from repro_torch.core.power import power_method
    from repro_torch.core.weights import accel_weights
    from repro_torch.graph.structure import Graph
    from repro_torch.kernels.ops import hits_sweep_bsr
    cfg = _cfg(name)
    n, s, d = webgraph.crawl(cfg, 7, scale=0.05)
    g = Graph(n, s, d)
    sweep, _lt, _l = hits_sweep_bsr(g, *accel_weights(g.indeg(), g.outdeg()),
                                    dtype="float64", device="cpu")
    tol = cfg["ranking"]["tol"]
    r = power_method(sweep, torch.full((n,), 1.0 / n, dtype=torch.float64),
                     tol=tol, max_iter=2000)
    hub, auth, sweeps = reference.crawl_ranking(n, s, d, tol, 2000)
    assert r.iters == sweeps
    assert np.abs(r.v - hub).sum() < 1e-13
    assert np.abs(r.aux / np.abs(r.aux).sum() - auth).sum() < 1e-13


def test_accel_weights_match_the_port():
    from repro_torch.core.weights import accel_weights
    rng = np.random.default_rng(0)
    indeg, outdeg = rng.integers(0, 5, 200), rng.integers(0, 5, 200)
    for a, b in zip(reference.accel_weights(indeg, outdeg),
                    accel_weights(indeg, outdeg)):
        np.testing.assert_allclose(a, b, rtol=1e-15, atol=0)


@pytest.mark.parametrize("name", ["reference.py", "webgraph.py",
                                  "roofline.py"])
def test_yardstick_imports_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "rankbench" / name).read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add((node.module or "").split(".")[0])
    assert mods <= {"__future__", "numpy", "zlib"}, mods
