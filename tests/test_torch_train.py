"""The port's training runtime (``repro_torch.train``) against the JAX
package's ``repro.train`` on the CPU: the schedule, AdamW on identical
params, gradients and state, clipping, one train step per recsys
architecture, gradient accumulation, int8 compression with error
feedback (``ef_compressed_psum`` over 8 host shards against the
reference's ``shard_map`` over 8 forced host devices, in a subprocess),
the data pipeline's determinism and a loss that falls.

Tolerances: the schedule rtol 1e-6; AdamW on identical inputs 1e-6
relative to each leaf's magnitude (both add in f32 in the same order; an
ulp of ``cos`` or of a fused add may differ); a train step as in
``test_torch_recsys``: loss 1e-5, gradients 1e-4, and the params after
AdamW 1e-6 except where the gradient is within its tolerance of zero.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_recsys as R
from repro.configs import get_spec as ref_spec
from repro.train import AdamWConfig as RefAdamW
from repro.train import adamw_update as ref_adamw
from repro.train import clip_by_global_norm as ref_clip
from repro.train import global_norm as ref_global_norm
from repro.train import init_opt_state as ref_init_opt
from repro.train import lr_schedule as ref_lr
from repro.train import make_train_step as ref_make_step
from repro.train import compression as rc
from repro_torch import configs as pconfigs
from repro_torch.models import recsys as ps
from repro_torch.sparse import dist
from repro_torch.train import (AdamWConfig, DataConfig, adamw_update,
                               bst_batch, clip_by_global_norm, global_norm,
                               init_opt_state, lm_batch, lr_schedule,
                               make_train_step, recsys_batch, shard_of_batch,
                               twotower_batch)
from repro_torch.train import compression as pc
from repro_torch.train.data import to_device
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
N_SHARDS = 8


def tree_np(seed=0, scale=1.0):
    """A seeded tree in the reference's shape: a dict of a matrix, a tuple
    and a nested dict."""
    rng = np.random.default_rng(seed)
    f = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa
    return {"table": f(30, 4), "mlp": {"w": (f(4, 6), f(6, 1)),
                                       "b": (f(6), f(1))}, "pos": f(3)}


def as_torch(tree):
    return tree_map(lambda x: torch.from_numpy(np.array(x)), tree)


def as_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def rel_close(got, want, rel):
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=rel,
                                   atol=rel * max(np.abs(w).max(), 1e-30))


def test_lr_schedule_matches_reference():
    for oc in (dict(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1),
               dict(lr=3e-3, warmup_steps=5, total_steps=60),
               dict(lr=1e-3, warmup_steps=0, total_steps=7,
                    min_lr_frac=0.0)):
        for s in list(range(0, 130)) + [10_000, 123_457]:
            np.testing.assert_allclose(
                lr_schedule(AdamWConfig(**oc), s),
                float(ref_lr(RefAdamW(**oc), s)), rtol=1e-6, atol=0)
    oc = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                     min_lr_frac=0.1)
    assert lr_schedule(oc, 0) == 0.0
    assert np.isclose(lr_schedule(oc, 10), 1.0)
    assert lr_schedule(oc, 100) <= 0.11 and lr_schedule(oc, 55) < 1.0


@pytest.mark.parametrize("start", [0, 5])
def test_adamw_update_matches_reference(start):
    """Identical params, gradients and state (zero at step 0; seeded
    moments at step 5): params, m, v and step after one update."""
    oc = dict(lr=1e-2, warmup_steps=3, total_steps=20, weight_decay=0.1,
              clip_norm=0.5)
    p, g = tree_np(0), tree_np(1, scale=0.3)
    if start:
        m = tree_np(2, scale=0.1)
        v = tree_map(lambda x: np.abs(x) * 0.01, tree_np(3))
    else:
        m = v = tree_map(np.zeros_like, p)
    rstate = {"m": as_jax(m), "v": as_jax(v),
              "step": jnp.asarray(start, jnp.int32)}
    rp, rs_, rm = ref_adamw(as_jax(p), as_jax(g), rstate, RefAdamW(**oc))
    state = {"m": as_torch(m), "v": as_torch(v),
             "step": torch.tensor(start, dtype=torch.int32)}
    tp = as_torch(p)
    pp, ps_, pm = adamw_update(tp, as_torch(g), state, AdamWConfig(**oc))
    assert pp is tp  # in place
    rel_close(pp, rp, 1e-6)
    rel_close(ps_["m"], rs_["m"], 1e-6)
    rel_close(ps_["v"], rs_["v"], 1e-6)
    assert int(ps_["step"]) == int(rs_["step"]) == start + 1
    assert ps_["step"].dtype == torch.int32
    np.testing.assert_allclose(pm["lr"], float(rm["lr"]), rtol=1e-6)
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)


def test_adamw_chunks_like_one_pass(monkeypatch):
    """The chunked in-place update gives the bits of a single pass."""
    from repro_torch.train import optimizer
    oc = AdamWConfig(lr=1e-2, warmup_steps=1)
    outs = []
    for chunk in (1 << 26, 7):
        monkeypatch.setattr(optimizer, "CHUNK", chunk)
        p = as_torch(tree_np(0))
        st = init_opt_state(p)
        for s in range(3):
            adamw_update(p, as_torch(tree_np(10 + s)), st, oc)
        outs.append(leaves(p) + leaves(st["m"]) + leaves(st["v"]))
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_clip_and_global_norm():
    for scale, clip in ((0.3, 0.5), (0.01, 5.0), (0.0, 1.0)):
        g = tree_np(4, scale)
        want = ref_global_norm(as_jax(g))
        np.testing.assert_allclose(float(global_norm(as_torch(g))),
                                   float(want), rtol=1e-6)
        rg, rn = ref_clip(as_jax(g), clip)
        pg, pn = clip_by_global_norm(as_torch(g), clip)
        rel_close(pg, rg, 1e-6)
        np.testing.assert_allclose(float(pn), float(rn), rtol=1e-6)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_train_step_matches_reference(arch):
    """One reference train step against the port's on the same params
    and batch, per architecture: loss 1e-5, the global norm 1e-4, and the
    params after AdamW 1e-6, except where the reference's gradient is
    within the gradient tolerance of zero (AdamW's first step moves such
    an element by ±lr whatever its tiny value, so a sign that differs
    moves it 2·lr apart): those may differ by up to 2.1·lr, and the ones
    that differ by more than 1e-6 are counted, at most 1 % of all."""
    cfg = ref_spec(arch).smoke_config
    params, loss, model = R.carried(arch, cfg)
    batch = R.np_batch(arch, cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    _, grads = jax.value_and_grad(loss)(params, jb)
    rp, _, rm = jax.jit(ref_make_step(loss, RefAdamW(**oc)))(
        params, ref_init_opt(params), jb)
    _, _, pm = make_train_step(lambda m, b: m.loss(b), AdamWConfig(**oc))(
        model, init_opt_state(model), R.tensors(batch))
    R.close(pm["loss"].numpy(), rm["loss"], 1e-5, 1e-5)
    R.close(pm["grad_norm"].numpy(), rm["grad_norm"], 1e-4, 0)
    exempt = total = 0
    for got, want, g in zip(leaves(model.to_tree()), jax.tree.leaves(rp),
                            jax.tree.leaves(grads)):
        g = np.abs(np.asarray(g))
        free = g <= 1e-4 * max(g.max(), 1e-30)
        d = np.abs(got.detach().numpy() - np.asarray(want))
        assert (d[~free] <= 1e-6).all()
        assert (d[free] <= 2.1e-3).all()
        exempt += int((free & (d > 1e-6)).sum())
        total += g.size
    assert exempt <= 0.01 * total, (exempt, total)


@pytest.mark.parametrize("arch", ["dlrm-rm2", "bst"])
def test_grad_accum_two_equals_one(arch):
    """accum=2 microbatching == one batch: the same loss (rtol 1e-5; the
    reference's test allows 1e-3) and params within 2e-5 (the
    reference's bound), and the loss equal to the reference's accum=2
    step (1e-5)."""
    cfg = ref_spec(arch).smoke_config
    params, loss, _ = R.carried(arch, cfg)
    batch = R.np_batch(arch, cfg)
    oc = AdamWConfig(lr=1e-3, clip_norm=1e9)
    res = []
    for accum in (1, 2):
        _, _, model = R.carried(arch, cfg)
        _, _, m = make_train_step(lambda md, b: md.loss(b), oc,
                                  grad_accum=accum)(
            model, init_opt_state(model), R.tensors(batch))
        res.append((float(m["loss"]), leaves(model.to_tree())))
    assert np.isclose(res[0][0], res[1][0], rtol=1e-5)
    for a, b in zip(res[0][1], res[1][1]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-5)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    _, _, rm = jax.jit(ref_make_step(loss, RefAdamW(lr=1e-3, clip_norm=1e9),
                                     grad_accum=2))(params,
                                                    ref_init_opt(params), jb)
    np.testing.assert_allclose(res[1][0], float(rm["loss"]), rtol=1e-5)


def test_compression_matches_reference():
    """compress_leaf: q and scale equal to the reference's, the carried
    error within an ulp of the scale; the round trip within one int8 step
    (the reference's bound)."""
    g, err = tree_np(5, 0.02), tree_np(6, 0.001)
    (rq, rsc), rerr = rc.compress_grads(as_jax(g), as_jax(err))
    (pq, psc), perr = pc.compress_grads(as_torch(g), as_torch(err))
    for a, b in zip(leaves(pq), jax.tree.leaves(rq)):
        assert a.dtype == torch.int8 and np.array_equal(a.numpy(),
                                                        np.asarray(b))
    rel_close(psc, rsc, 1e-7)
    for a, b, s in zip(leaves(perr), jax.tree.leaves(rerr), leaves(psc)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-6 * float(s))
    grads = tree_map(lambda p: torch.full(p.shape, 0.01), as_torch(g))
    comp, _ = pc.compress_grads(grads, pc.init_error_state(grads))
    for x, d in zip(leaves(grads), leaves(pc.decompress_grads(comp))):
        assert float((x - d).abs().max()) <= float(x.abs().max()) / 127 \
            + 1e-12


def test_error_feedback_accumulates():
    """The error is carried, so the mean dequantized gradient over many
    steps converges to the true gradient (the reference's test)."""
    g = torch.full((64,), 0.003)
    err, total = torch.zeros(64), torch.zeros(64)
    g = g.clone()
    g[0] = 1.0  # the scale is set by one large element
    for _ in range(50):
        q, s, err = pc.compress_leaf(g, err)
        total = total + q.float() * s
    np.testing.assert_allclose((total / 50)[1:].numpy(), 0.003, rtol=0.05)


def ef_inputs():
    """Per-shard gradient and error trees, seeded."""
    return ([tree_np(100 + s, 0.05) for s in range(N_SHARDS)],
            [tree_np(200 + s, 0.0005) for s in range(N_SHARDS)])


def compute_oracle(path):
    import jax
    from jax.sharding import PartitionSpec as P
    jax.config.update("jax_enable_x64", True)
    assert len(jax.devices()) == N_SHARDS, jax.devices()
    from repro.compat import make_mesh, set_mesh, shard_map
    from repro.train.compression import ef_compressed_psum as ref_ef
    grads, errs = ef_inputs()
    stack = lambda ts: jax.tree.map(lambda *x: jnp.stack(x), *ts)  # noqa
    mesh = make_mesh((N_SHARDS,), ("d",))

    def body(g, e):
        g = jax.tree.map(lambda x: x[0], g)
        e = jax.tree.map(lambda x: x[0], e)
        out, err = ref_ef(g, e, "d")
        return (jax.tree.map(lambda x: x[None], out),
                jax.tree.map(lambda x: x[None], err))

    spec = jax.tree.map(lambda _x: P("d"), grads[0])
    f = shard_map(body, mesh=mesh, in_specs=(spec, spec),
                  out_specs=(spec, spec))
    with set_mesh(mesh):
        out, err = jax.jit(f)(stack(grads), stack(errs))
    flat = {}
    for name, tree in (("out", out), ("err", err)):
        for i, x in enumerate(jax.tree.leaves(tree)):
            flat[f"{name}/{i}"] = np.asarray(x)
    np.savez(path, **flat)


@pytest.fixture(scope="module")
def ef_oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("ef_oracle") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}"
               f"{ROOT / 'tests'}", JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS=f"--xla_force_host_platform_device_count="
                         f"{N_SHARDS}")
    out = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def test_ef_compressed_psum_matches_reference(ef_oracle):
    """Over 8 host shards: every shard's mean gradient equal to the
    reference's (the int32 sum is exact; the scale's division may differ
    by an ulp: 1e-6 relative) and its error within 1e-6 of the scale;
    the collectives counted (one pmax and one int32 psum a leaf)."""
    grads, errs = ef_inputs()
    mesh = dist.make_mesh(N_SHARDS, device="cpu")
    out, err = pc.ef_compressed_psum(mesh, [as_torch(g) for g in grads],
                                     [as_torch(e) for e in errs])
    n_leaves = len(leaves(grads[0]))
    for i in range(n_leaves):
        want_o, want_e = ef_oracle[f"out/{i}"], ef_oracle[f"err/{i}"]
        for s in range(N_SHARDS):
            o, e = leaves(out[s])[i].numpy(), leaves(err[s])[i].numpy()
            np.testing.assert_allclose(o, want_o[s], rtol=1e-6,
                                       atol=1e-6 * np.abs(want_o).max())
            np.testing.assert_allclose(e, want_e[s], rtol=0,
                                       atol=1e-6 * np.abs(want_o).max()
                                       * N_SHARDS)
        assert np.array_equal(leaves(out[0])[i].numpy(),
                              leaves(out[N_SHARDS - 1])[i].numpy())
    sizes = [x.size for x in leaves(grads[0])]
    assert mesh.collective_bytes == {"all-reduce": 4 * n_leaves
                                     + 4 * sum(sizes)}


def test_data_determinism_and_elastic_remap():
    """Every batch is a pure function of (seed, step); 4-shard and 8-shard
    slicing tile the same global batch; the distributions have the
    reference's structure."""
    dc = DataConfig(kind="lm", global_batch=16, seq_len=8, vocab=64, seed=3)
    b1, b2 = lm_batch(dc, 7), lm_batch(dc, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], lm_batch(dc, 8)["tokens"])
    s4 = [shard_of_batch(b1, i, 4)["tokens"] for i in range(4)]
    s8 = [shard_of_batch(b1, i, 8)["tokens"] for i in range(8)]
    assert torch.equal(torch.cat(s4), torch.cat(s8))
    # the even-position repeat: labels[:, 2j+1] == tokens[:, 2j+1]'s
    # successor position 2j+2 repeats position 2j+1
    toks = torch.cat([b1["tokens"], b1["labels"][:, -1:]], dim=1)
    assert torch.equal(toks[:, 2::2], toks[:, 1:-1:2])
    rc_ = DataConfig(kind="recsys", global_batch=4096, sparse_vocab=50)
    rb = recsys_batch(rc_, 0)
    assert rb["dense"].shape == (4096, 13) and rb["sparse"].shape == (4096,
                                                                      26)
    assert int(rb["sparse"].max()) < 50 and int(rb["sparse"].min()) >= 0
    agree = ((rb["dense"][:, 0] > 0).float() == rb["label"]).float().mean()
    assert agree > 0.9
    bb = bst_batch(DataConfig(kind="bst", global_batch=64, sparse_vocab=9),
                   2, seq_len=5)
    assert bb["hist"].shape == (64, 5) and int(bb["hist"].max()) < 9
    tb = twotower_batch(DataConfig(kind="twotower", global_batch=256), 1,
                        100, 70)
    off = (tb["item"] - tb["user"] * 7) % 70
    assert set(off.tolist()) <= {0, 1, 2}
    for b in (rb, bb, tb):
        same = to_device(b, "cpu")
        assert all(torch.equal(x, y) for x, y in zip(leaves(b),
                                                     leaves(same)))


def test_training_reduces_loss():
    """90 smoke steps of DLRM on ``recsys_batch`` (whose label follows a
    dense feature): the last loss is below 0.8 of the first."""
    cfg = pconfigs.get_spec("dlrm-rm2").smoke_config
    model = ps.build(cfg, seed=0, device="cpu")
    step = make_train_step(lambda m, b: m.loss(b),
                           AdamWConfig(lr=1e-2, warmup_steps=5,
                                       total_steps=90))
    st = init_opt_state(model)
    dc = DataConfig(kind="recsys", global_batch=64,
                    sparse_vocab=cfg.vocab_per_field)
    losses = []
    for i in range(90):
        _, st, m = step(model, st, recsys_batch(dc, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < 0.8 * losses[0], losses[::10]
    assert int(st["step"]) == 90


if __name__ == "__main__":
    compute_oracle(sys.argv[1])
