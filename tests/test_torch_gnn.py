"""The port's GNN family (``repro_torch.models.gnn``, the sampler
``repro_torch.graph.sampler`` and the aggregation on K3,
``repro_torch.kernels.ops.aggregate``) against the JAX package's
``repro.models.gnn`` and ``repro.graph.sampler`` on the CPU, from the
same numpy-seeded inputs and the reference's parameters carried across
(``params_from_reference``). Smoke size: 2 layers, d_hidden 16, 50 nodes
and 200 edges.

Tolerances (f32, as both packages compute GIN): logits, losses and
gradients within 1e-5 of the largest magnitude of the reference's value
(K3 sums each tile's row in f64 and rounds once, XLA adds edge by edge
in f32; the matmuls add in other orders). The sampler fed the
reference's draws is compared exactly; the aggregation's gradient is
checked by ``torch.autograd.gradcheck`` in f64.
"""
import re
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED as REF_ASSIGNED
from repro.configs import get_spec as ref_spec
from repro.configs.gin_tu import for_shape as ref_for_shape
from repro.graph import SamplerTables as RefTables
from repro.graph import WebGraphSpec as RefSpec
from repro.graph import generate_webgraph as ref_generate
from repro.graph import khop_sizes as ref_khop_sizes
from repro.kernels import build_tiled_segments as ref_build_tiled_segments
from repro.graph import sample_khop as ref_sample_khop
from repro.models import gnn as rg
from repro.train import AdamWConfig as RefAdamW
from repro.train import init_opt_state as ref_init_opt
from repro.train import make_train_step as ref_train_step
from repro_torch import configs as pconfigs
from repro_torch.configs.gin_tu import for_shape
from repro_torch.graph import (SamplerTables, from_reference, khop_sizes,
                               sample_khop)
from repro_torch.graph.sampler import sample_layer
from repro_torch.kernels import ops as pops
from repro_torch.models import gnn as pg
from repro_torch.train import (AdamWConfig, init_opt_state, make_train_step,
                               value_and_grad)
from repro_torch.tree import leaves

from test_torch_launch import launch

N, E, G = 50, 200, 4  # nodes and edges of a graph; graphs of a batch
TOL = 1e-5


def close(got, want, tol=TOL):
    """Within ``tol`` of the largest magnitude of ``want``."""
    got, want = (np.asarray(x.detach() if torch.is_tensor(x) else x,
                            np.float64) for x in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * scale, (err, scale)


def cfg_of(agg="segment"):
    return pg.GINConfig(**{**vars(pconfigs.get_spec("gin-tu")
                                  .smoke_config), "agg": agg})


@lru_cache(maxsize=None)
def ref_params(seed=0):
    cfg = rg.GINConfig(**vars(cfg_of()))
    return rg.init_gin_params(cfg, jax.random.key(seed))


def carried(agg="segment", seed=0):
    """(reference params, port GIN holding them, port config)."""
    cfg = cfg_of(agg)
    params = ref_params(seed)
    model = pg.GIN(cfg, device="cpu").params_from_reference(
        jax.tree.map(np.asarray, params))
    return params, model, cfg


def full_batch(seed=0, n=N, e=E, pad=0):
    """A seeded full-graph batch; ``pad`` extra edges with dst = n (the
    reference's dry-run padding, which ``segment_sum`` drops)."""
    rng = np.random.default_rng(seed)
    d_in, c = cfg_of().d_in, cfg_of().n_classes
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int32)])
        dst = np.concatenate([dst, np.full(pad, n, np.int32)])
    return {"x": rng.standard_normal((n, d_in)).astype(np.float32),
            "src": src, "dst": dst,
            "labels": rng.integers(0, c, n).astype(np.int32),
            "train_mask": (rng.random(n) > 0.3).astype(np.float32)}


def graph_batch(seed=1, g=G, n=12, e=30):
    """G padded graphs: the last nodes and edges of each are padding."""
    rng = np.random.default_rng(seed)
    d_in, c = cfg_of().d_in, cfg_of().n_classes
    n_real = rng.integers(n // 2, n + 1, g)
    e_real = rng.integers(e // 2, e + 1, g)
    src = np.stack([rng.integers(0, k, e) for k in n_real]).astype(np.int32)
    dst = np.stack([rng.integers(0, k, e) for k in n_real]).astype(np.int32)
    return {"x": rng.standard_normal((g, n, d_in)).astype(np.float32),
            "src": src, "dst": dst,
            "node_mask": np.arange(n)[None, :] < n_real[:, None],
            "edge_mask": np.arange(e)[None, :] < e_real[:, None],
            "labels": rng.integers(0, c, g).astype(np.int32)}


def sampled_batch(seed=2, n=N, e=E, seeds=8):
    rng = np.random.default_rng(seed)
    d_in, c = cfg_of().d_in, cfg_of().n_classes
    return {"feats": rng.standard_normal((n, d_in)).astype(np.float32),
            "edge_src": rng.integers(0, n, e).astype(np.int32),
            "edge_dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": rng.random(e) > 0.2,
            "labels": rng.integers(0, c, seeds).astype(np.int32),
            "n_seeds": seeds}


def grouped_batch(seed=3, g=3, n=15, e=25, seeds=4):
    """(G, n, f) subgraphs: ``tests/test_perf_variants.py``'s layout."""
    rng = np.random.default_rng(seed)
    d_in, c = cfg_of().d_in, cfg_of().n_classes
    return {"feats": rng.standard_normal((g, n, d_in)).astype(np.float32),
            "edge_src": rng.integers(0, n, (g, e)).astype(np.int32),
            "edge_dst": rng.integers(0, n, (g, e)).astype(np.int32),
            "edge_mask": rng.random((g, e)) > 0.2,
            "labels": rng.integers(0, c, (g, seeds)).astype(np.int32)}


def tensors(batch):
    return {k: torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
            else v for k, v in batch.items()}


def jnps(batch):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in batch.items()}


# ---------------------------------------------------------------- params
def test_init_tree_paths_shapes_dtypes():
    """``GIN`` holds the reference's tree: same paths (in jax's leaf
    order), shapes and dtypes; the reference's scales (1/sqrt(fan_in)
    normal encoder, weights and classifier, zero eps and biases); the
    same seed gives the same bits."""
    cfg = cfg_of()
    ref = ref_params()
    m = pg.GIN(cfg, seed=3, device="cpu")
    tree = m.to_tree()
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    from repro_torch.tree import walk
    got = list(walk(tree))
    assert [jax.tree_util.keystr(p) for p, _ in want] == \
        ["".join(f"['{x[2:]}']" for x in p) for p, _ in got]
    for (_, w), (_, t) in zip(want, got):
        assert tuple(t.shape) == w.shape and str(t.dtype)[6:] == str(w.dtype)
    assert not m.layers.eps.any() and not m.layers.b1.any() \
        and not m.layers.b2.any()
    big = pg.GIN(pg.GINConfig("g", n_layers=3, d_in=400, d_hidden=300,
                              n_classes=200), device="cpu")
    for t, fan in ((big.encoder, 400), (big.layers.w1, 300),
                   (big.classifier, 300)):
        assert abs(t.std().item() * np.sqrt(fan) - 1) < 0.02
    m2 = pg.GIN(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(tree),
                                                 leaves(m2.to_tree())))


def test_gin_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pg.GIN(cfg_of())


# ------------------------------------------------------------ forwards
def test_gin_forward_and_node_logits():
    params, model, _ = carried()
    b = full_batch()
    args = (b["x"], b["src"], b["dst"])
    close(pg.gin_forward(model, *map(torch.from_numpy, args)),
          rg.gin_forward(params, *map(jnp.asarray, args)))
    close(pg.gin_node_logits(model, *map(torch.from_numpy, args)),
          rg.gin_node_logits(params, *map(jnp.asarray, args)))


def test_gin_graph_logits_single_and_batched():
    """The flattened batch against the reference's vmap, and each graph
    alone against the reference's ``gin_graph_logits``."""
    params, model, _ = carried()
    b = graph_batch()
    keys = ("x", "src", "dst", "node_mask", "edge_mask")
    want = rg.gin_graph_logits_batched(params, *(jnp.asarray(b[k])
                                                 for k in keys))
    got = pg.gin_graph_logits_batched(model, *(torch.from_numpy(b[k])
                                               for k in keys))
    close(got, want)
    for i in range(G):
        close(pg.gin_graph_logits(model, *(torch.from_numpy(b[k][i])
                                           for k in keys)),
              rg.gin_graph_logits(params, *(jnp.asarray(b[k][i])
                                            for k in keys)))


@pytest.mark.parametrize("agg", ["segment", "onehot"])
def test_gin_sampled_logits(agg):
    params, model, _ = carried(agg)
    b = sampled_batch()
    keys = ("feats", "edge_src", "edge_dst", "edge_mask")
    close(pg.gin_sampled_logits(model, *(torch.from_numpy(b[k])
                                         for k in keys), b["n_seeds"],
                                agg_mode=agg),
          rg.gin_sampled_logits(params, *(jnp.asarray(b[k]) for k in keys),
                                b["n_seeds"], agg_mode=agg))


@pytest.mark.parametrize("agg", ["segment", "onehot"])
def test_gin_sampled_batched_loss(agg):
    """Against the reference, and (``tests/test_perf_variants.py``) equal
    to the mean of ``sampled_loss`` over the groups, and the two modes
    within 1e-5 of each other."""
    params, model, cfg = carried(agg)
    b = grouped_batch()
    got = pg.gin_sampled_batched_loss(model, tensors(b), cfg, n_seeds=4)
    close(got, rg.gin_sampled_batched_loss(params, jnps(b),
                                           rg.GINConfig(**vars(cfg)),
                                           n_seeds=4))
    per = [pg.sampled_loss(model, {**{k: torch.from_numpy(v[i])
                                      for k, v in b.items()}, "n_seeds": 4},
                           cfg) for i in range(3)]
    close(got, torch.stack(per).mean())
    _, other, ocfg = carried("onehot" if agg == "segment" else "segment")
    close(pg.gin_sampled_batched_loss(other, tensors(b), ocfg, n_seeds=4),
          got)


# ------------------------------------------------------ losses and grads
LOSSES = {
    "node": (pg.node_loss, rg.node_loss, full_batch, "segment"),
    "node_no_mask": (pg.node_loss, rg.node_loss,
                     lambda: {k: v for k, v in full_batch().items()
                              if k != "train_mask"}, "segment"),
    "graph": (pg.graph_loss, rg.graph_loss, graph_batch, "segment"),
    "sampled_segment": (pg.sampled_loss, rg.sampled_loss, sampled_batch,
                        "segment"),
    "sampled_onehot": (pg.sampled_loss, rg.sampled_loss, sampled_batch,
                       "onehot"),
    "batched_segment": (partial(pg.gin_sampled_batched_loss, n_seeds=4),
                        partial(rg.gin_sampled_batched_loss, n_seeds=4),
                        grouped_batch, "segment"),
    "batched_onehot": (partial(pg.gin_sampled_batched_loss, n_seeds=4),
                       partial(rg.gin_sampled_batched_loss, n_seeds=4),
                       grouped_batch, "onehot"),
}


def ref_loss(case):
    ploss, rloss, make, agg = LOSSES[case]
    rcfg = rg.GINConfig(**vars(cfg_of(agg)))
    return (lambda p, b: rloss(p, b, cfg=rcfg)), \
        (lambda m, b: ploss(m, b, cfg=cfg_of(agg))), make, agg


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_losses_and_gradients(case):
    """Every loss and the gradient of every parameter (``jax.grad``
    against autograd) from the reference's parameters."""
    rloss, ploss, make, agg = ref_loss(case)
    params, model, _ = carried(agg)
    b = make()
    lv, gr = jax.value_and_grad(rloss)(params, jnps(b))
    pv, gp = value_and_grad(ploss, model, tensors(b))
    close(pv, lv)
    for got, want in zip(leaves(gp), jax.tree.leaves(gr)):
        close(got, want)


def test_train_step():
    """One AdamW step of ``node_loss``: loss and gradient norm within
    1e-5, and every parameter within 1e-5 of the reference's step, apart
    from elements whose gradient is below 1e-6 of its leaf's largest
    (AdamW's first step moves an element by about ±lr whatever its
    gradient's size, so a near-zero gradient whose sign XLA and ATen
    disagree on moves it 2·lr apart); at most 2 % of the elements."""
    params, model, cfg = carried()
    b = full_batch()
    rcfg = rg.GINConfig(**vars(cfg))
    _, grads = jax.value_and_grad(partial(rg.node_loss, cfg=rcfg))(
        params, jnps(b))
    rstep = ref_train_step(partial(rg.node_loss, cfg=rcfg), RefAdamW())
    p2, _, rm = rstep(params, ref_init_opt(params), jnps(b))
    pstep = make_train_step(lambda m, bt: pg.node_loss(m, bt, cfg),
                            AdamWConfig())
    _, opt, pm = pstep(model, init_opt_state(model), tensors(b))
    close(pm["loss"], rm["loss"])
    close(pm["grad_norm"], rm["grad_norm"])
    assert int(opt["step"]) == 1
    exempt = total = 0
    for got, want, g in zip(leaves(model.to_tree()), jax.tree.leaves(p2),
                            jax.tree.leaves(grads)):
        got, want, g = got.detach().numpy(), np.asarray(want), \
            np.abs(np.asarray(g))
        off = np.abs(got - want) > TOL * np.abs(want).max()
        assert (g[off] < 1e-6 * g.max()).all()
        exempt += int(off.sum())
        total += g.size
    assert exempt <= 0.02 * total, (exempt, total)


def test_dropped_edges():
    """Edges with dst = N (the reference's dry-run padding) are dropped:
    the port's logits with them equal its logits without them bit for
    bit and the reference's with them within 1e-5."""
    params, model, _ = carried()
    b, p = full_batch(), full_batch(pad=24)
    t = lambda bb: [torch.from_numpy(bb[k]) for k in ("x", "src", "dst")]  # noqa: E731
    got = pg.gin_node_logits(model, *t(p))
    assert torch.equal(got, pg.gin_node_logits(model, *t(b)))
    close(got, rg.gin_node_logits(params, *(jnp.asarray(p[k])
                                            for k in ("x", "src", "dst"))))
    lay = pops.EdgeLayouts.of(*t(p)[1:], N)
    assert int(lay.fwd.valid.sum()) == int(lay.rev.valid.sum()) == E


# ------------------------------------------------------ the aggregation
@pytest.mark.parametrize("grouped", [False, True])
def test_aggregate_gradcheck(grouped):
    """``torch.autograd.gradcheck`` of the aggregation Function in f64
    (edge weights, out-of-range edges, small tiles so blocks span several
    tiles), and its value against a dense adjacency product."""
    rng = np.random.default_rng(7)
    n, e = 20, 90
    shape = (3, e) if grouped else (e,)
    src = torch.from_numpy(rng.integers(0, n + 1, shape))
    dst = torch.from_numpy(rng.integers(-1, n + 1, shape))
    w = torch.from_numpy(rng.random(shape))
    rows = 3 * n if grouped else n
    h = torch.randn(rows, 5, dtype=torch.float64, requires_grad=True)
    lay = pops.EdgeLayouts.of(src, dst, n, bs=8, tile_e=4)
    assert torch.autograd.gradcheck(lambda x: pops.aggregate(x, lay, w),
                                    (h,))
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    base = (torch.arange(3)[:, None] * n) if grouped else 0
    a = torch.zeros(rows, rows, dtype=torch.float64)
    a.index_put_(((dst + base)[keep], (src + base)[keep]), w[keep],
                 accumulate=True)
    close(pops.aggregate(h, lay, w), (a @ h).detach(), 1e-13)


@pytest.mark.parametrize("n,e,bs,tile_e", [(50, 200, 16, 16),
                                            (300, 2000, 32, 32),
                                            (1000, 10, 128, 8),
                                            (10, 0, 16, 4)])
def test_tiled_layout_matches_reference_layout(n, e, bs, tile_e):
    """``tiled_layout`` (torch) gives the JAX package's
    ``build_tiled_segments`` layout (no edges included)."""
    dst = np.random.default_rng(n).integers(0, n, e).astype(np.int32)
    ref = ref_build_tiled_segments(dst, n, bs=bs, tile_e=tile_e)
    got = pops.tiled_layout(torch.from_numpy(dst), n, bs, tile_e)
    for k in ("perm", "blkid", "off", "valid"):
        assert np.array_equal(got[k].numpy(),
                              np.asarray(ref[k]).reshape(-1)), k
    assert np.array_equal(got["tile_ptr"].numpy(),
                          pops.tile_ptr_of(np.asarray(ref["blkid"]),
                                           ref["n_blocks"]))
    assert (got["n_blocks"], got["e_pad"]) == (ref["n_blocks"],
                                               ref["e_pad"])


def test_layouts_cached_by_edge_tensors():
    """One build per pair of edge tensors, dropped with them; equal
    values in other tensors build anew."""
    b = tensors(full_batch())
    lay = pops.EdgeLayouts.of(b["src"], b["dst"], N)
    assert pops.EdgeLayouts.of(b["src"], b["dst"], N) is lay
    assert pops.EdgeLayouts.of(b["src"].clone(), b["dst"], N) is not lay
    n0 = len(pops._EDGE_CACHE)
    del b
    assert len(pops._EDGE_CACHE) < n0


# --------------------------------------------------------------- sampler
@lru_cache(maxsize=None)
def sampler_graph(n=300, e=2400, seed=5):
    return ref_generate(RefSpec(n, e, 0.5, seed=seed))


def ref_draws(key, seeds, fanouts):
    """The reference's per-layer draws of ``sample_khop``."""
    out, b = [], len(seeds)
    for f in fanouts:
        key, sub = jax.random.split(key)
        out.append(torch.from_numpy(np.asarray(
            jax.random.randint(sub, (b, f), 0, 2 ** 31 - 1))))
        b *= f
    return out


@pytest.mark.parametrize("fanouts,max_deg", [((5, 3), 32), ((4, 2, 2), 4),
                                             ((15, 10), 8)])
def test_sampler_matches_reference_draws(fanouts, max_deg):
    """Fed the reference's draws, ``sample_khop`` gives its nodes,
    edge_src, edge_dst and edge_mask exactly; the tables equal."""
    rgph = sampler_graph()
    rt = RefTables.build(rgph, max_deg=max_deg)
    pt = SamplerTables.build(from_reference(rgph), max_deg, device="cpu")
    assert np.array_equal(pt.nbr.numpy(), np.asarray(rt.nbr))
    assert np.array_equal(pt.deg.numpy(), np.asarray(rt.deg))
    seeds = np.arange(0, 32, 2, dtype=np.int32)
    key = jax.random.key(11)
    want = ref_sample_khop(key, rt, jnp.asarray(seeds), fanouts)
    got = sample_khop(pt, torch.from_numpy(seeds), fanouts,
                      draws=ref_draws(key, seeds, fanouts))
    for k in ("nodes", "edge_src", "edge_dst", "edge_mask"):
        assert np.array_equal(getattr(got, k).numpy(),
                              np.asarray(getattr(want, k))), k
    assert got.n_seeds == want.n_seeds == len(seeds)


def test_khop_sizes():
    for s, f in ((16, (5, 3)), (1024, (15, 10)), (3, ()), (7, (2, 2, 2))):
        assert khop_sizes(s, f) == ref_khop_sizes(s, f)


def test_sampler_shapes_and_masks():
    """``tests/test_graph_infra.py::test_sampler_shapes_and_masks``."""
    g = from_reference(sampler_graph())
    tabs = SamplerTables.build(g, 32, device="cpu")
    gen = torch.Generator().manual_seed(0)
    sub = sample_khop(tabs, torch.arange(16), (5, 3), generator=gen)
    n_tot, e_tot = khop_sizes(16, (5, 3))
    assert sub.nodes.shape == (n_tot,)
    assert sub.edge_src.shape == (e_tot,)
    deg = g.outdeg()
    nodes = sub.nodes.numpy()
    src_nodes = nodes[sub.edge_src.numpy()]
    em = sub.edge_mask.numpy()
    dst_nodes = nodes[sub.edge_dst.numpy()]
    assert (deg[dst_nodes[em]] > 0).all()
    assert not em.all() and em.any()  # the graph has dangling pages
    edges = set(zip(g.src.tolist(), g.dst.tolist()))
    for s, d, m in zip(src_nodes, dst_nodes, em):
        if m:
            assert (int(d), int(s)) in edges
        else:
            assert s == d  # a zero-degree parent yields itself


def test_sampler_deterministic():
    """``tests/test_graph_infra.py::test_sampler_deterministic``: the same
    generator seed gives the same sample; a sample made ``like=`` another
    shares its message edges and layouts."""
    g = from_reference(ref_generate(RefSpec(200, 1500, 0.4, seed=6)))
    tabs = SamplerTables.build(g, 16, device="cpu")
    s1 = sample_khop(tabs, torch.arange(8), (4, 2),
                     generator=torch.Generator().manual_seed(42))
    s2, s3 = (sample_khop(tabs, torch.arange(8), (4, 2), like=s1,
                          generator=torch.Generator().manual_seed(sd))
              for sd in (42, 43))
    assert torch.equal(s1.nodes, s2.nodes)
    assert torch.equal(s1.edge_mask, s2.edge_mask)
    assert not torch.equal(s1.nodes, s3.nodes)
    assert s1.edge_src is s3.edge_src and s1.edge_dst is s3.edge_dst
    assert s1.lay is s3.lay
    with pytest.raises(ValueError, match="another shape"):
        sample_khop(tabs, torch.arange(6), (4, 2), like=s1)


@pytest.mark.parametrize("agg", ["segment", "onehot"])
def test_sample_carries_its_layouts(agg):
    """A sample's ``lay`` is the layouts of its own edges over its nodes,
    and ``sampled_loss`` given them in the batch (``"lay"``) gives the
    loss and gradients it gives without them."""
    g = from_reference(sampler_graph())
    tabs = SamplerTables.build(g, 32, device="cpu")
    sub = sample_khop(tabs, torch.arange(16), (5, 3),
                      generator=torch.Generator().manual_seed(3))
    want = pops.EdgeLayouts.build(sub.edge_src, sub.edge_dst,
                                  sub.nodes.shape[0])
    for side in ("fwd", "rev"):
        for f in ("rows", "edge", "blkid", "off", "valid", "tile_ptr"):
            assert torch.equal(getattr(getattr(sub.lay, side), f),
                               getattr(getattr(want, side), f)), (side, f)
    _, model, cfg = carried(agg)
    gen = torch.Generator().manual_seed(4)
    b = {"feats": torch.randn((sub.nodes.shape[0], cfg.d_in), generator=gen),
         "edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
         "edge_mask": sub.edge_mask, "n_seeds": sub.n_seeds,
         "labels": torch.randint(0, cfg.n_classes, (16,), generator=gen)}
    fn = lambda m, x: pg.sampled_loss(m, x, cfg)  # noqa: E731
    l0, g0 = value_and_grad(fn, model, b)
    l1, g1 = value_and_grad(fn, model, dict(b, lay=sub.lay))
    assert torch.equal(l0, l1)
    assert all(torch.equal(x, y) for x, y in zip(leaves(g0), leaves(g1)))


def test_sample_layer_zero_degree_and_draw_range():
    """Zero-degree seeds yield themselves, masked; draws are taken modulo
    the degree."""
    from repro_torch.graph import Graph
    g = Graph(4, np.array([0, 0, 1], np.int32), np.array([1, 2, 3],
                                                         np.int32))
    tabs = SamplerTables.build(g, 4, device="cpu")
    draws = torch.tensor([[0, 1, 2 ** 31 - 2], [5, 6, 7], [3, 3, 3]])
    nbrs, mask = sample_layer(tabs, torch.tensor([0, 1, 2]), 3, draws=draws)
    assert nbrs.tolist() == [[1, 2, 1], [3, 3, 3], [2, 2, 2]]
    assert mask.tolist() == [[True] * 3, [True] * 3, [False] * 3]


# -------------------------------------------------- registry and launcher
def test_registry():
    """``gin-tu`` resolves with the reference's configs, shapes and
    ``for_shape``; nothing is left unported."""
    assert pconfigs.NOT_PORTED == ()
    assert pconfigs.ASSIGNED == REF_ASSIGNED
    spec, ref = pconfigs.get_spec("gin-tu"), ref_spec("gin-tu")
    assert spec.family == ref.family == "gnn"
    assert vars(spec.config) == vars(ref.config)
    assert vars(spec.smoke_config) == vars(ref.smoke_config)
    assert spec.shapes == ref.shapes and spec.notes == ref.notes
    for shape in spec.shapes.values():
        assert vars(for_shape(shape)) == vars(ref_for_shape(shape))


STEP_LINE = re.compile(r"^step +(\d+) loss ([0-9.]+) lr [0-9.e+-]+ "
                       r"gnorm [0-9.]+$", re.M)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_launcher_trains_and_resumes_across_packages(writer, tmp_path):
    """``launch.train --arch gin-tu --smoke``: the reference's
    ``step``/``done:`` lines (3 steps: 0 and 2), and a checkpoint written
    by either package's launcher resumes in the other."""
    ck = str(tmp_path / "ck")
    other = "repro" if writer == "repro_torch" else "repro_torch"
    dev = lambda pkg: ["--device", "cpu"] if pkg == "repro_torch" else []  # noqa: E731
    out = launch(f"{writer}.launch.train", "--arch", "gin-tu", "--smoke",
                 "--steps", "3", "--ckpt", ck, "--ckpt-every", "3",
                 *dev(writer), cwd=tmp_path)
    assert [int(m.group(1)) for m in STEP_LINE.finditer(out)] == [0, 2]
    assert "done: 3 steps" in out
    out = launch(f"{other}.launch.train", "--arch", "gin-tu", "--smoke",
                 "--steps", "5", "--ckpt", ck, "--resume", *dev(other),
                 cwd=tmp_path)
    assert "resumed from step 3" in out and "done: 2 steps" in out
    assert [int(m.group(1)) for m in STEP_LINE.finditer(out)] == [4]
