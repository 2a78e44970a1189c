"""The port's recsys family (``repro_torch.models``) against the JAX
package's ``repro.models.recsys`` on the CPU, from the same numpy-seeded
inputs and the reference's parameters carried across
(``params_from_reference``).

Tolerances (f32 throughout, as both packages compute these models):
outputs (logits, losses, scores) rtol 1e-5 with an atol of 1e-5 of the
largest magnitude; gradients rtol 1e-4 with an atol of 1e-4 of the
leaf's largest magnitude (XLA and ATen add the batch in other orders).
Embedding lookups and bags, ``bipartite_interactions`` and the top-k
indices are compared exactly.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as rck
from repro.configs import get_spec as ref_spec
from repro.core import accel_hits as ref_accel
from repro.graph import bipartite_interactions as ref_bipartite
from repro.models import layers as rl
from repro.models import recsys as rs
from repro_torch import configs as pconfigs
from repro_torch.checkpoint import checkpoint as pck
from repro_torch.core import accel_hits
from repro_torch.graph import bipartite_interactions
from repro_torch.models import layers as pl
from repro_torch.models import recsys as ps
from repro_torch.train import (AdamWConfig, init_opt_state, make_train_step,
                               value_and_grad)
from repro_torch.tree import leaves

ARCHS = ("dlrm-rm2", "dcn-v2", "bst", "two-tower-retrieval")
B = 16


def close(got, want, rtol, rel_atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = rel_atol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def np_batch(arch, cfg, seed=0, b=B):
    """A seeded numpy batch in the reference's layout."""
    rng = np.random.default_rng(seed)
    if arch in ("dlrm-rm2", "dcn-v2"):
        return {"dense": rng.standard_normal((b, cfg.n_dense))
                .astype(np.float32),
                "sparse": rng.integers(0, cfg.vocab_per_field,
                                       (b, cfg.n_sparse)),
                "label": (rng.random(b) > 0.5).astype(np.float32)}
    if arch == "bst":
        return {"hist": rng.integers(0, cfg.vocab, (b, cfg.seq_len)),
                "target": rng.integers(0, cfg.vocab, b),
                "label": (rng.random(b) > 0.5).astype(np.float32)}
    user = rng.integers(0, cfg.n_users, b)
    return {"user": user, "item": (user * 7 + rng.integers(0, 3, b))
            % cfg.n_items}


@lru_cache(maxsize=None)
def ref_model(arch, cfg, seed=0):
    """(params, loss(params, batch)) of the reference (made once per
    arch, config and seed: JAX arrays are immutable)."""
    key = jax.random.key(seed)
    if arch == "dlrm-rm2":
        off = rs.unified_table_offsets(cfg.vocab_sizes)
        return rs.init_dlrm_params(cfg, key), partial(rs.dlrm_loss, cfg=cfg,
                                                      offsets=off)
    if arch == "dcn-v2":
        off = rs.unified_table_offsets(cfg.vocab_sizes)
        return rs.init_dcn_params(cfg, key), partial(rs.dcn_loss, cfg=cfg,
                                                     offsets=off)
    if arch == "bst":
        return rs.init_bst_params(cfg, key), partial(rs.bst_loss, cfg=cfg)
    return rs.init_twotower_params(cfg, key), partial(rs.twotower_loss,
                                                      cfg=cfg)


def ref_logits(arch, params, batch, cfg):
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    if arch == "dlrm-rm2":
        return rs.dlrm_logits(params, j["dense"], j["sparse"], cfg,
                              rs.unified_table_offsets(cfg.vocab_sizes))
    if arch == "dcn-v2":
        return rs.dcn_logits(params, j["dense"], j["sparse"], cfg,
                             rs.unified_table_offsets(cfg.vocab_sizes))
    if arch == "bst":
        return rs.bst_logits(params, j["hist"], j["target"], cfg)
    return rs.retrieval_scores(params, j["user"], j["item"])


def port_logits(arch, model, batch):
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    if arch in ("dlrm-rm2", "dcn-v2"):
        return model(t["dense"], t["sparse"])
    if arch == "bst":
        return model(t["hist"], t["target"])
    return ps.retrieval_scores(model, t["user"], t["item"])


def carried(arch, cfg, seed=0):
    """The reference's params and loss, and a port module holding them."""
    params, loss = ref_model(arch, cfg, seed)
    pcfg = getattr(ps, type(cfg).__name__)(**vars(cfg))
    model = ps.build(pcfg, seed=seed + 1, device="cpu") \
        .params_from_reference(params)
    return params, loss, model


def tensors(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------- lookups
def test_embedding_lookup_and_bag_equal():
    rng = np.random.default_rng(0)
    vocab = [7, 11, 5]
    off = rs.unified_table_offsets(vocab)
    assert np.array_equal(off, ps.unified_table_offsets(vocab))
    table = rng.standard_normal((sum(vocab), 6)).astype(np.float32)
    ids = np.stack([rng.integers(0, v, 9) for v in vocab], axis=1)
    want = rs.embedding_lookup(jnp.asarray(table), jnp.asarray(ids), off)
    got = ps.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids),
                              off)
    assert np.array_equal(got.numpy(), np.asarray(want))
    flat = rng.integers(0, sum(vocab), 40)
    seg = rng.integers(0, 12, 40)  # unsorted, two empty bags at most
    seg[:2] = 11
    w = rng.random(40).astype(np.float32)
    for combiner in ("sum", "mean"):
        for weights in (None, w):
            want = rs.embedding_bag(
                jnp.asarray(table), jnp.asarray(flat), jnp.asarray(seg), 13,
                combiner, None if weights is None else jnp.asarray(weights))
            got = ps.embedding_bag(torch.from_numpy(table),
                                   torch.from_numpy(flat),
                                   torch.from_numpy(seg), 13, combiner,
                                   None if weights is None
                                   else torch.from_numpy(weights))
            close(got.numpy(), want, 1e-6, 1e-7)
            assert not got[12].any()  # the empty bag


def test_embedding_bag_gradient():
    """The bag's backward (sort + segment_reduce + F.embedding) against
    the reference's."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((20, 4)).astype(np.float32)
    flat, seg = rng.integers(0, 20, 30), rng.integers(0, 6, 30)
    w = rng.random(30).astype(np.float32)
    cot = rng.standard_normal((6, 4)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(rs.embedding_bag(
        t, jnp.asarray(flat), jnp.asarray(seg), 6, "mean",
        jnp.asarray(w)) * cot))(jnp.asarray(table))
    t = torch.from_numpy(table).requires_grad_()
    (ps.embedding_bag(t, torch.from_numpy(flat), torch.from_numpy(seg), 6,
                      "mean", torch.from_numpy(w))
     * torch.from_numpy(cot)).sum().backward()
    close(t.grad.numpy(), want, 1e-5, 1e-6)


# ------------------------------------------------------------ architectures
def test_tree_paths_match_reference():
    """The module's parameter tree holds the reference's keys in the
    reference's order (the checkpoint's flat keys), and its names are the
    reference's paths."""
    for arch in ARCHS:
        cfg = ref_spec(arch).smoke_config
        params, _loss = ref_model(arch, cfg)
        model = ps.build(pconfigs.get_spec(arch).smoke_config, device="cpu")
        want = list(rck._flatten(params))
        got = list(pck._flatten(_host(model.to_tree())))
        assert got == want, arch
        shapes = [tuple(np.shape(x)) for x in jax.tree.leaves(params)]
        assert [tuple(p.shape) for p in leaves(model.to_tree())] == shapes
    names = dict(ps.build(pconfigs.get_spec("dlrm-rm2").smoke_config,
                          device="cpu").named_parameters())
    assert {"table", "bot.w.0", "bot.b.1", "top.w.2"} <= set(names)
    names = dict(ps.build(pconfigs.get_spec("bst").smoke_config,
                          device="cpu").named_parameters())
    assert {"blocks.wq", "blocks.ff2", "pos", "mlp.b.2"} <= set(names)
    names = dict(ps.build(pconfigs.get_spec(
        "two-tower-retrieval").smoke_config, device="cpu")
        .named_parameters())
    assert {"user_tower.b.1", "item_tower.w.0", "item_table"} <= set(names)


def _host(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().numpy(), tree)


def test_init_scales():
    """Init draws with the reference's scales: 0.01 tables, 1/sqrt(fan_in)
    MLP weights, zero biases, BST's ff2 at half its fan-in scale; the same
    seed gives the same bits."""
    cfg = ps.DLRMConfig(vocab_per_field=2000, n_sparse=4)
    m = ps.DLRM(cfg, seed=3, device="cpu")
    assert abs(m.table.std().item() - 0.01) < 5e-4
    for w, b in zip(m.bot.w, m.bot.b):
        assert abs(w.std().item() * np.sqrt(w.shape[0]) - 1) < 0.1
        assert not b.any()
    m2 = ps.DLRM(cfg, seed=3, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(m.parameters(),
                                                 m2.parameters()))
    bst = ps.BST(ps.BSTConfig(vocab=50, embed_dim=64, n_heads=4,
                              mlp=(16,)), device="cpu")
    s = 1 / np.sqrt(64)
    assert abs(bst.blocks.ff2.std().item() / (0.5 * s) - 1) < 0.05
    assert abs(bst.blocks.wq.std().item() / s - 1) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_loss_and_grads_match(arch):
    """Logits (scores for the two-tower), loss and every gradient from the
    reference's parameters on the reference's batch."""
    cfg = ref_spec(arch).smoke_config
    params, loss, model = carried(arch, cfg)
    batch = np_batch(arch, cfg)
    close(port_logits(arch, model, batch).detach().numpy(),
          ref_logits(arch, params, batch, cfg), 1e-5, 1e-5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lv, gr = jax.value_and_grad(loss)(params, jb)
    pv, gp = value_and_grad(lambda m, b: m.loss(b), model, tensors(batch))
    close(pv.numpy(), lv, 1e-5, 1e-5)
    for got, want in zip(leaves(gp), jax.tree.leaves(gr)):
        close(got.numpy(), want, 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_recsys_smoke(arch):
    """Mirror of ``tests/test_smoke_archs.py::test_recsys_smoke``: the
    smoke config's outputs and one AdamW step are finite."""
    cfg = pconfigs.get_spec(arch).smoke_config
    model = ps.build(cfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(0)
    b = 16
    if arch in ("dlrm-rm2", "dcn-v2"):
        batch = {"dense": torch.randn((b, 13), generator=g),
                 "sparse": torch.randint(0, cfg.vocab_per_field, (b, 26),
                                         generator=g),
                 "label": torch.full((b,), 0.5 if arch == "dlrm-rm2"
                                     else 0.0)}
        out = model(batch["dense"], batch["sparse"])
    elif arch == "bst":
        batch = {"hist": torch.randint(0, cfg.vocab, (b, cfg.seq_len),
                                       generator=g),
                 "target": torch.randint(0, cfg.vocab, (b,), generator=g),
                 "label": torch.ones((b,))}
        out = model(batch["hist"], batch["target"])
    else:
        batch = {"user": torch.randint(0, cfg.n_users, (b,), generator=g),
                 "item": torch.randint(0, cfg.n_items, (b,), generator=g)}
        out = ps.retrieval_scores(model, batch["user"][:2],
                                  torch.arange(cfg.n_items))
    assert torch.isfinite(out).all()
    step = make_train_step(lambda m, bt: m.loss(bt), AdamWConfig())
    _, _, metrics = step(model, init_opt_state(model), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert all(torch.isfinite(p).all() for p in model.parameters())


# ------------------------------------------------------------ attention
ATTN = {
    "causal": dict(sq=19, skv=19, h=4, hkv=4, causal=True, window=None,
                   chunk=8),
    "bidirectional": dict(sq=19, skv=19, h=4, hkv=4, causal=False,
                          window=None, chunk=8),
    "windowed": dict(sq=19, skv=19, h=4, hkv=4, causal=True, window=5,
                     chunk=4),
    "gqa": dict(sq=16, skv=16, h=6, hkv=2, causal=True, window=None,
                chunk=8),
    "padded_last_chunk": dict(sq=5, skv=21, h=2, hkv=1, causal=False,
                              window=None, chunk=8),
    "offset": dict(sq=4, skv=12, h=2, hkv=2, causal=True, window=6,
                   chunk=5, q_offset=8),
}


@pytest.mark.parametrize("case", sorted(ATTN))
def test_chunked_attention_matches(case):
    """Forward (rtol 1e-5) and the gradient of a random cotangent
    (rtol 1e-4) against the reference's ``chunked_attention``."""
    c = dict(ATTN[case])
    sq, skv, h, hkv = c.pop("sq"), c.pop("skv"), c.pop("h"), c.pop("hkv")
    rng = np.random.default_rng(len(case))
    q = rng.standard_normal((2, sq, h, 8)).astype(np.float32)
    k = rng.standard_normal((2, skv, hkv, 8)).astype(np.float32)
    v = rng.standard_normal((2, skv, hkv, 8)).astype(np.float32)
    cot = rng.standard_normal((2, sq, h, 8)).astype(np.float32)
    f = partial(rl.chunked_attention, **c)
    want, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = pl.chunked_attention(tq, tk, tv, **c)
    close(got.detach().numpy(), want, 1e-5, 1e-5)
    got.backward(torch.from_numpy(cot))
    for t, w in zip((tq, tk, tv), vjp(jnp.asarray(cot))):
        close(t.grad.numpy(), w, 1e-4, 1e-4)


# ------------------------------------------------------------ retrieval
def tt_pair(n_users=40, n_items=60):
    cfg = rs.TwoTowerConfig(name="tt", embed_dim=8, tower_mlp=(16, 8),
                            n_users=n_users, n_items=n_items)
    params = rs.init_twotower_params(cfg, jax.random.key(0))
    model = ps.TwoTower(ps.TwoTowerConfig(**vars(cfg)), device="cpu") \
        .params_from_reference(params)
    return params, model


@pytest.mark.parametrize("prior", [None, "float64", "float32"])
def test_retrieval_scores_and_topk(prior):
    """Scores (rtol 1e-5, float64 when the prior is) and top-k indices
    equal, for 5 users over 60 candidates, k 20."""
    params, model = tt_pair()
    rng = np.random.default_rng(5)
    users, cands = np.arange(5), rng.permutation(60)
    pr = None if prior is None else (rng.random(60) + 1e-3).astype(prior)
    kw = {} if pr is None else dict(prior_weight=0.7)
    want = rs.retrieval_scores(params, jnp.asarray(users),
                               jnp.asarray(cands),
                               None if pr is None else jnp.asarray(pr), **kw)
    got = ps.retrieval_scores(model, torch.from_numpy(users),
                              torch.from_numpy(cands),
                              None if pr is None else torch.from_numpy(pr),
                              **kw)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    close(got.detach().numpy(), want, 1e-5, 1e-5)
    wv, wi = rs.retrieval_topk(params, jnp.asarray(users), jnp.asarray(cands),
                               20, None if pr is None else jnp.asarray(pr),
                               **kw)
    gv, gi = ps.retrieval_topk(model, torch.from_numpy(users),
                               torch.from_numpy(cands), 20,
                               None if pr is None else torch.from_numpy(pr),
                               **kw)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    close(gv.detach().numpy(), wv, 1e-5, 1e-5)


def test_topk_ties_go_to_the_lowest_index():
    s = np.array([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0, 2.0, 0.0]])
    wv, wi = jax.lax.top_k(jnp.asarray(s), 5)
    gv, gi = ps.topk(torch.from_numpy(s), 5)
    assert gi.tolist() == np.asarray(wi).tolist() == [[1, 2, 4, 3, 6]]
    assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("args", [(2000, 3000, 30000, 2.0, 7),
                                  (300, 500, 4000, 2.0, 3),
                                  (50, 20, 400, 1.5, 0)])
def test_bipartite_interactions_equal(args):
    a, b = bipartite_interactions(*args), ref_bipartite(*args)
    assert a.n_nodes == b.n_nodes
    assert np.array_equal(a.src, b.src) and np.array_equal(a.dst, b.dst)


def test_retrieval_with_hits_prior():
    """Mirror of ``tests/test_system.py::test_retrieval_with_hits_prior``
    on the port, from the reference's two-tower parameters: the prior's
    top-50 has a higher mean authority than the base top-50, and both
    lists equal the reference's."""
    n_users, n_items = 300, 500
    g = bipartite_interactions(n_users, n_items, 4000, seed=3)
    r = accel_hits(g, tol=1e-9, device="cpu")
    rr = ref_accel(ref_bipartite(n_users, n_items, 4000, seed=3), tol=1e-9)
    assert r.iters == rr.iters
    assert np.abs(r.aux - np.asarray(rr.aux)).sum() <= 1e-10
    prior = r.aux[n_users:] + 1e-12
    cfg = rs.TwoTowerConfig(name="tt", embed_dim=8, tower_mlp=(16, 8),
                            n_users=n_users, n_items=n_items)
    params = rs.init_twotower_params(cfg, jax.random.key(0))
    model = ps.TwoTower(ps.TwoTowerConfig(**vars(cfg)), device="cpu") \
        .params_from_reference(params)
    cands = torch.arange(n_items)
    _, base = ps.retrieval_topk(model, torch.tensor([5]), cands, k=50)
    _, pri = ps.retrieval_topk(model, torch.tensor([5]), cands, k=50,
                               prior=torch.from_numpy(prior),
                               prior_weight=1.0)
    base, pri = base[0].numpy(), pri[0].numpy()
    assert prior[pri].mean() > prior[base].mean()
    _, rb = rs.retrieval_topk(params, jnp.array([5]), jnp.arange(n_items),
                              k=50)
    _, rp = rs.retrieval_topk(params, jnp.array([5]), jnp.arange(n_items),
                              k=50, prior=jnp.asarray(prior),
                              prior_weight=1.0)
    assert np.array_equal(base, np.asarray(rb[0]))
    assert np.array_equal(pri, np.asarray(rp[0]))


def test_no_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ps.DLRM(pconfigs.get_spec("dlrm-rm2").smoke_config)


def test_registry():
    assert pconfigs.ASSIGNED == ["deepseek-v2-236b", "mixtral-8x7b",
                                 "deepseek-7b", "minitron-4b", "minitron-8b",
                                 "gin-tu", "two-tower-retrieval", "dlrm-rm2",
                                 "dcn-v2", "bst"]
    for arch in ARCHS:
        spec, ref = pconfigs.get_spec(arch), ref_spec(arch)
        assert spec.family == ref.family == "recsys"
        assert vars(spec.config) == vars(ref.config)
        assert vars(spec.smoke_config) == vars(ref.smoke_config)
        assert spec.shapes == ref.shapes
    assert pconfigs.get_spec("hits-webgraph").shapes == \
        ref_spec("hits-webgraph").shapes
    assert len(pconfigs.all_cells()) == 40
    assert len(pconfigs.all_cells(include_ranking=True)) == 43
    for arch, family in (("deepseek-7b", "lm"), ("gin-tu", "gnn")):
        assert pconfigs.get_spec(arch).family == ref_spec(arch).family \
            == family
    with pytest.raises(KeyError, match="unknown"):
        pconfigs.get_spec("nope")
