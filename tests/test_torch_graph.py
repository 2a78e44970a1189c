"""The port's numpy host layer (``repro_torch.graph``, ``core.weights``,
``core.reordering``) against the JAX package: same inputs from a seed,
``np.array_equal`` outputs. Also: the port imports neither jax nor repro."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.core.reordering as r_reorder
import repro.core.weights as r_weights
import repro.graph as rg
import repro_torch.core as pc
import repro_torch.graph as pg

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def same_graph(a, b):
    assert a.n_nodes == b.n_nodes
    assert np.array_equal(a.src, b.src) and a.src.dtype == b.src.dtype
    assert np.array_equal(a.dst, b.dst) and a.dst.dtype == b.dst.dtype


@pytest.mark.parametrize("name", ["britannica", "jobs", "wikipedia", "yahoo"])
def test_paper_dataset_equal(name):
    same_graph(pg.paper_dataset(name, 0.02, seed=3),
               rg.paper_dataset(name, 0.02, seed=3))


def test_generate_webgraph_and_table_equal():
    assert pg.PAPER_TABLE7 == rg.PAPER_TABLE7
    spec = dict(n_nodes=300, n_edges=2500, dangling_frac=0.6, seed=11)
    same_graph(pg.generate_webgraph(pg.WebGraphSpec(**spec)),
               rg.generate_webgraph(rg.WebGraphSpec(**spec)))


def test_from_reference_copies():
    g = rg.paper_dataset("jobs", 0.02)
    p = pg.from_reference(g)
    same_graph(p, g)
    assert not np.shares_memory(p.src, g.src)


def test_structure_helpers_equal():
    g = rg.paper_dataset("opera", 0.01, seed=1)
    p = pg.from_reference(g)
    for x, y in ((g.outdeg(), p.outdeg()), (g.indeg(), p.indeg()),
                 (g.dedup().src, p.dedup().src), (g.reverse().dst,
                                                  p.reverse().dst),
                 (g.sort_by_dst().src, p.sort_by_dst().src)):
        assert np.array_equal(x, y)
    rc, pc_ = rg.to_csr(g), pg.to_csr(p)
    assert np.array_equal(rc.ptr, pc_.ptr) and np.array_equal(rc.cols, pc_.cols)
    for cap in (None, 4):
        for x, y in zip(rg.padded_neighbors(g, cap), pg.padded_neighbors(p, cap)):
            assert np.array_equal(x, y)
    assert [pg.next_pow2(x) for x in range(40)] == \
        [rg.structure.next_pow2(x) for x in range(40)]


@pytest.mark.parametrize("bs", [16, 32])
def test_to_bsr_equal_and_f64_not_quantized(bs):
    g = rg.paper_dataset("python", 0.01, seed=2)
    p = pg.from_reference(g)
    vals = np.random.default_rng(0).random(g.n_edges)  # not f32-representable
    for v in (None, vals):
        rb, pb = rg.to_bsr(g, bs, values=v), pg.to_bsr(p, bs, values=v)
        for f in ("blocks", "brow", "bcol", "row_ptr"):
            x, y = getattr(rb, f), getattr(pb, f)
            assert np.array_equal(x, y) and x.dtype == y.dtype, f
    assert pb.blocks.dtype == np.float64


def test_subgraph_extract_and_union_equal():
    g = rg.paper_dataset("britannica", 0.03, seed=0)
    rx = rg.SubgraphExtractor(g, out_cap=8, in_cap=6)
    px = pg.SubgraphExtractor(pg.from_reference(g), out_cap=8, in_cap=6)
    rng = np.random.default_rng(5)
    rs, ps = [], []
    for _ in range(4):
        roots = rng.choice(g.n_nodes, size=7, replace=False)
        a, b = rx.extract(roots), px.extract(roots)
        assert a.key == b.key == pg.root_set_key(roots) == \
            rg.root_set_key(roots)
        assert np.array_equal(a.nodes, b.nodes)
        assert np.array_equal(a.roots_local, b.roots_local)
        same_graph(a.graph, b.graph)
        rs.append(a)
        ps.append(b)
    ua, ub = rx.extract_union(rs), px.extract_union(ps)
    assert ua.key == ub.key and np.array_equal(ua.nodes, ub.nodes)
    same_graph(ua.graph, ub.graph)


def test_accel_weights_and_blocking_permutation_equal():
    g = rg.paper_dataset("scholarpedia", 0.005, seed=4)
    for x, y in zip(r_weights.accel_weights(g.indeg(), g.outdeg()),
                    pc.accel_weights(g.indeg(), g.outdeg())):
        assert np.array_equal(x, y)
    n = g.n_nodes + 9  # padded, with isolated tail rows
    assert np.array_equal(r_reorder.blocking_permutation(g.src, g.dst, n),
                          pc.blocking_permutation(g.src, g.dst, n))


def test_port_imports_neither_jax_nor_repro():
    """By AST over every module of the package, and by sys.modules after
    importing all of it in a fresh interpreter."""
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text(), str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)
        rel = path.relative_to(PORT.parent).with_suffix("")
        mods.append(".".join(p for p in rel.parts if p != "__init__"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
