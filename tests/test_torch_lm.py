"""The port's LM family (``repro_torch.models.transformer``, ``layers``,
``serve.kvquant``) against the JAX package's on the CPU, from the same
numpy-seeded inputs and the reference's parameters carried across
(``params_from_reference``).

Each of the five smoke configs runs ``forward``, ``loss_fn`` and its
gradients, and 30 greedy ``decode_step``s (past mixtral-smoke's window
of 16, so its rolling buffer wraps): the dense ones here, the MoE ones
(deepseek-v2, mixtral) in ``tests/test_torch_moe.py``, which imports
these helpers. Decode feeds both packages the reference's greedy
tokens, so one near-tie cannot fork the sequences.

Tolerances. At f32 compute: outputs (hidden states, logits, losses)
rtol 1e-5 with an atol of 1e-5 of the largest magnitude; gradients rtol
1e-4 with an atol of 1e-4 of the leaf's largest magnitude (XLA and ATen
add in other orders); decode tokens equal. At bf16 compute the reference
runs in one subprocess (this file as a script) with
``--xla_allow_excess_precision=false``, so it rounds every op to bf16 as
its source is written (XLA on the CPU otherwise keeps f32 between ops);
the port rounds the same ops (its ``silu`` is XLA's op-by-op logistic).
Bounds in bf16 ulps at the largest magnitude M (ulp <= M * 2**-7):
hidden states and logits atol M * 2**-6 (two ulps; measured: equal bits
on the five smoke configs), the f32 loss rtol 2**-8, gradients atol M * 2**-5 per
leaf (four ulps: backward's bf16 ops round in another order than JAX's
autodiff; measured at most 0.0160 M), and the argmax equal to the
reference's token wherever the reference's top-two margin exceeds the
logits' bound. ``n_params``/``n_active_params`` and cache shapes are
exact.
"""
import dataclasses
import os
import subprocess
import sys
from functools import lru_cache, partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_spec as ref_spec
from repro.models import layers as rl
from repro.models import transformer as rt
from repro.serve import kvquant as rkv
from repro_torch import configs as pconfigs
from repro_torch.models import layers as pl
from repro_torch.models import transformer as pt
from repro_torch.serve import kvquant as pkv
from repro_torch.tree import leaves, walk

ROOT = Path(__file__).resolve().parents[1]
LM_ARCHS = ("deepseek-v2-236b", "mixtral-8x7b", "deepseek-7b",
            "minitron-4b", "minitron-8b")
ARCHS = ("deepseek-7b", "minitron-4b", "minitron-8b")  # this file's
B, S, STEPS = 2, 12, 30


def close(got, want, rtol, rel_atol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = rel_atol * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def f32(x):
    """A tensor or array as an f32 numpy array (bf16 converts exactly)."""
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def smoke(arch, cdt, pkg):
    spec = (ref_spec if pkg == "ref" else pconfigs.get_spec)(arch)
    return dataclasses.replace(spec.smoke_config, compute_dtype=cdt)


def inputs(cfg):
    rng = np.random.default_rng(0)
    return (rng.integers(0, cfg.vocab, (B, S)),
            rng.integers(0, cfg.vocab, (B, S)))


@lru_cache(maxsize=None)
def ref_params(arch):
    """The reference's smoke parameters (f32 whatever the compute dtype)."""
    cfg = ref_spec(arch).smoke_config
    return jax.jit(partial(rt.init_params, cfg))(jax.random.key(0))


def reference_run(arch, cdt):
    """The JAX package's forward, loss, gradients and 30 greedy decode
    steps, as f32 numpy arrays."""
    cfg = smoke(arch, cdt, "ref")
    params = ref_params(arch)
    toks, labels = inputs(cfg)

    def fwd_grad(p, b):
        x, aux = rt.forward(p, b["tokens"], cfg)
        loss, g = jax.value_and_grad(rt.loss_fn)(p, b, cfg)
        return x, aux, loss, g
    x, aux, loss, g = jax.jit(fwd_grad)(
        params, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    out = {"x": f32(x), "aux": f32(aux), "loss": f32(loss)}
    out.update({f"g{i}": f32(leaf) for i, leaf in enumerate(
        jax.tree.leaves(g))})
    step = jax.jit(partial(rt.decode_step, cfg=cfg))
    cache = rt.init_cache(cfg, B, STEPS + 2)
    tok, logits, tokens = jnp.asarray(toks[:, 0]), [], []
    for pos in range(STEPS):
        lg, cache = step(params, cache, tok, jnp.array(pos))
        tok = jnp.argmax(lg, axis=-1)
        logits.append(f32(lg))
        tokens.append(np.asarray(tok))
    out["logits"], out["tokens"] = np.stack(logits), np.stack(tokens)
    return out


@lru_cache(maxsize=None)
def port_model(arch, cdt):
    return pt.Transformer(smoke(arch, cdt, "port"), device="cpu") \
        .params_from_reference(jax.tree.map(np.asarray, ref_params(arch)))


def port_run(arch, cdt, ref_tokens):
    """The port's forward, loss, gradients, and 30 decode steps fed the
    reference's tokens."""
    from repro_torch.train import value_and_grad
    model = port_model(arch, cdt)
    cfg = model.cfg
    toks, labels = inputs(cfg)
    with torch.no_grad():
        x, aux = pt.forward(model, torch.as_tensor(toks), cfg)
    loss, g = value_and_grad(lambda m, b: m.loss(b), model,
                             {"tokens": torch.as_tensor(toks),
                              "labels": torch.as_tensor(labels)})
    out = {"x": f32(x), "aux": f32(aux), "loss": f32(loss)}
    out.update({f"g{i}": f32(leaf) for i, leaf in enumerate(leaves(g))})
    cache = model.init_cache(B, STEPS + 2)
    tok, logits = torch.as_tensor(toks[:, 0]), []
    for pos in range(STEPS):
        lg, cache = model.decode_step(cache, tok, pos)
        logits.append(f32(lg))
        tok = torch.as_tensor(ref_tokens[pos])
    out["logits"] = np.stack(logits)
    return out


@pytest.fixture(scope="module")
def bf16_proc(request, tmp_path_factory):
    """The reference at bf16, strict rounding, for the module's ``ARCHS``,
    started with the module's first test so it runs beside the f32
    comparisons."""
    path = tmp_path_factory.mktemp("lm_bf16") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, __file__, str(path),
                             *request.module.ARCHS], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(autouse=True, scope="module")
def _start_bf16(bf16_proc):
    yield


@pytest.fixture(scope="module")
def bf16_ref(bf16_proc):
    proc, path = bf16_proc
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        return dict(z)


def check_against_reference(arch, cdt, request):
    """forward, aux, loss, every gradient and 30 decode steps' logits and
    tokens against the JAX package (tolerances in the module docstring)."""
    if cdt == "float32":
        ref = reference_run(arch, cdt)
    else:
        z = request.getfixturevalue("bf16_ref")
        ref = {k.split("/", 1)[1]: v for k, v in z.items()
               if k.startswith(arch + "/")}
    got = port_run(arch, cdt, ref["tokens"])
    n_leaves = len(leaves(port_model(arch, cdt).to_tree()))
    assert sum(k.startswith("g") for k in ref) == n_leaves
    if cdt == "float32":
        for k in ("x", "aux", "loss"):
            close(got[k], ref[k], 1e-5, 1e-5)
        for i in range(n_leaves):
            close(got[f"g{i}"], ref[f"g{i}"], 1e-4, 1e-4)
        for pos in range(STEPS):
            close(got["logits"][pos], ref["logits"][pos], 1e-5, 1e-5)
        assert np.array_equal(got["logits"].argmax(-1), ref["tokens"])
        return
    close(got["x"], ref["x"], 0, 2 ** -6)
    close(got["loss"], ref["loss"], 2 ** -8, 0)
    close(got["aux"], ref["aux"], 2 ** -8, 0)
    for i in range(n_leaves):
        close(got[f"g{i}"], ref[f"g{i}"], 0, 2 ** -5)
    firm = 0
    for pos in range(STEPS):
        lg, want = got["logits"][pos], ref["logits"][pos]
        close(lg, want, 0, 2 ** -6)
        tol = 2 ** -6 * np.abs(want).max()
        top2 = np.sort(want, axis=-1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > tol
        assert np.array_equal(lg.argmax(-1)[sure], ref["tokens"][pos][sure])
        firm += int(sure.sum())
    assert firm >= STEPS * B // 2, firm


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_lm_matches_reference(arch, cdt, request):
    check_against_reference(arch, cdt, request)


def test_registry():
    """All five LM archs resolve, with the reference's configs, shapes and
    skips; parameter counts are exact at full and smoke size."""
    from repro.configs import ASSIGNED as REF_ASSIGNED
    assert pconfigs.ASSIGNED == REF_ASSIGNED
    for arch in LM_ARCHS:
        spec, ref = pconfigs.get_spec(arch), ref_spec(arch)
        assert spec.family == ref.family == "lm"
        for a, b in ((spec.config, ref.config),
                     (spec.smoke_config, ref.smoke_config)):
            assert vars(a) == vars(b)
            assert a.n_params() == b.n_params()
            assert a.n_active_params() == b.n_active_params()
        assert (spec.shapes, spec.skip_shapes, spec.notes) == \
            (ref.shapes, ref.skip_shapes, ref.notes)
    assert pconfigs.get_spec("deepseek-7b").config.n_params() == 6_910_365_696


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_cache_and_init(arch):
    """Cache shapes and dtypes (the rolling buffer under SWA, the MLA
    compressed cache); init: ones for the norms, an f32 router, normal x
    0.02 elsewhere in the parameter dtype, the same bits from the same
    seed."""
    for max_len in (8, 40):
        rc = rt.init_cache(ref_spec(arch).smoke_config, 3, max_len)
        pc = pt.init_cache(pconfigs.get_spec(arch).smoke_config, 3,
                           max_len, device="cpu")
        assert sorted(rc) == sorted(pc)
        for k in rc:
            assert tuple(pc[k].shape) == rc[k].shape
            assert pc[k].dtype == torch.bfloat16 and not pc[k].any()
    cfg = dataclasses.replace(pconfigs.get_spec(arch).smoke_config,
                              param_dtype="bfloat16")
    a, b = (pt.Transformer(cfg, seed=3, device="cpu").to_tree()
            for _ in range(2))
    for (path, x), y in zip(walk(a), leaves(b)):
        assert torch.equal(x, y)
        name = path[-1]
        if name in ("k=ln1", "k=ln2", "k=final_ln"):
            assert x.dtype == torch.bfloat16 and bool((x == 1).all())
        else:
            assert x.dtype == (torch.float32 if name == "k=router"
                               else torch.bfloat16)
            if x.numel() > 2000:
                assert abs(float(x.detach().float().std()) - 0.02) < 0.002


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_keeps_gradients(policy):
    """Remat (each layer under checkpoint; "dots" keeps the matmuls)
    gives the gradients of the model without it, bit for bit."""
    from repro_torch.train import value_and_grad
    base = dataclasses.replace(
        pconfigs.get_spec("mixtral-8x7b").smoke_config,
        compute_dtype="float32")
    toks, labels = inputs(base)
    batch = {"tokens": torch.as_tensor(toks),
             "labels": torch.as_tensor(labels)}
    runs = []
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat, remat_policy=policy)
        m = pt.Transformer(cfg, seed=1, device="cpu")
        runs.append(value_and_grad(lambda mm, b: mm.loss(b), m, batch))
    assert torch.equal(runs[0][0], runs[1][0])
    for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the layers
def test_rms_norm_rope_silu():
    """rms_norm and rope against the reference at f32 (1e-6 of the
    largest magnitude) and bf16 (one ulp); silu in bf16 bit for bit
    (XLA's op-by-op logistic)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32) * 3
    scale = rng.standard_normal(8).astype(np.float32)
    pos = np.arange(5)
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-6),
                         (torch.bfloat16, jnp.bfloat16, 2 ** -7)):
        xt, st = torch.from_numpy(x).to(dt), torch.from_numpy(scale).to(dt)
        xj, sj = jnp.asarray(x).astype(jdt), jnp.asarray(scale).astype(jdt)
        close(f32(pl.rms_norm(xt, st)), f32(rl.rms_norm(xj, sj)), 0, tol)
        close(f32(pl.rope(xt, torch.as_tensor(pos))),
              f32(rl.rope(xj, jnp.asarray(pos))), 0, tol)
        # decode's positions: (B, 1) against a (B, 1, H, dh) slice
        pb = np.array([[7], [30]])
        close(f32(pl.rope(xt[:, :1], torch.as_tensor(pb))),
              f32(rl.rope(xj[:, :1], jnp.asarray(pb))), 0, tol)
    v = jnp.asarray(rng.standard_normal(4096) * 4).astype(jnp.bfloat16)
    want = f32(jax.jit(jax.nn.silu)(v))
    got = f32(pl.silu(torch.from_numpy(f32(v)).bfloat16()))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("length,window", [(None, None), (7, None),
                                           (7, 4), (12, 5)])
def test_decode_attention(length, window):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 3, 8)).astype(np.float32)
            for _ in range(2))
    got = pl.decode_attention(*map(torch.from_numpy, (q, k, v)),
                              length=length, window=window)
    want = rl.decode_attention(*map(jnp.asarray, (q, k, v)), length=length,
                               window=window)
    close(f32(got), f32(want), 1e-5, 1e-5)


def test_chunked_softmax_xent_and_grad():
    """Vocab 100 in chunks of 32 (the last one padded and masked): the
    loss and its gradients in h and in the unembedding."""
    rng = np.random.default_rng(3)
    t, d, v = 32, 16, 100
    h = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((d, v)).astype(np.float32)
    labels = rng.integers(0, v, t)
    hj, wj = jnp.asarray(h), jnp.asarray(w)
    lr, (gh_r, gw_r) = jax.value_and_grad(
        lambda a, b: rl.chunked_softmax_xent(a, b, jnp.asarray(labels),
                                             chunk=32), (0, 1))(hj, wj)
    ht = torch.from_numpy(h).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    lp = pl.chunked_softmax_xent(ht, wt, torch.as_tensor(labels), chunk=32)
    gh, gw = torch.autograd.grad(lp, (ht, wt))
    close(f32(lp), f32(lr), 1e-5, 1e-5)
    close(f32(gh), f32(gh_r), 1e-4, 1e-4)
    close(f32(gw), f32(gw_r), 1e-4, 1e-4)
    full = torch.nn.functional.cross_entropy(
        torch.from_numpy(h) @ torch.from_numpy(w), torch.as_tensor(labels))
    close(f32(lp), f32(full), 1e-5, 1e-5)


def test_mlps():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 5, 8)).astype(np.float32)
    ws = [rng.standard_normal(s).astype(np.float32) * 0.3
          for s in ((8, 16), (8, 16), (16, 8))]
    close(f32(pl.mlp_swiglu(*map(torch.from_numpy, [x] + ws))),
          f32(rl.mlp_swiglu(*map(jnp.asarray, [x] + ws))), 1e-5, 1e-5)
    bs = [rng.standard_normal(16).astype(np.float32),
          rng.standard_normal(8).astype(np.float32)]
    got = pl.dense_mlp(torch.from_numpy(x), [torch.from_numpy(ws[0]),
                                             torch.from_numpy(ws[2])],
                       [torch.from_numpy(b) for b in bs], final_act=True)
    want = rl.dense_mlp(jnp.asarray(x), [jnp.asarray(ws[0]),
                                         jnp.asarray(ws[2])],
                        [jnp.asarray(b) for b in bs], final_act=True)
    close(f32(got), f32(want), 1e-5, 1e-5)


@pytest.mark.parametrize("attn", ["gqa", "mla"])
def test_decode_matches_forward(attn):
    """The port's decode against its own forward, at the reference's test
    sizes and bound (``tests/test_models.py``: 2e-4 at f32); MLA decodes
    with the absorbed products, a different computation."""
    if attn == "mla":
        cfg = pt.TransformerConfig(
            name="c", n_layers=2, d_model=32, n_heads=4, n_kv_heads=4,
            d_head=12, d_ff=64, vocab=64, attn_type="mla", q_lora_rank=16,
            kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8,
            remat=False, attn_chunk=8, compute_dtype="float32")
    else:
        cfg = pt.TransformerConfig(
            name="c", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
            d_head=8, d_ff=64, vocab=64, remat=False, attn_chunk=8,
            compute_dtype="float32")
    model = pt.Transformer(cfg, seed=8, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(9).integers(0, 64, (3, 10)))
    with torch.no_grad():
        x, _ = model(toks)
        logits_fwd = torch.einsum("bsd,dv->bsv", x, model.unembed)
    cache = model.init_cache(3, 16)
    for i in range(10):
        lg, cache = model.decode_step(cache, toks[:, i], i)
        np.testing.assert_allclose(f32(lg), f32(logits_fwd[:, i]),
                                   atol=2e-4)


# ----------------------------------------------------------------- kvquant
def test_kvquant_matches_reference():
    """int8 values equal (half to even: the row [127, .5, 1.5, 2.5, -.5,
    -2.5, ...] has scale 1 and lands on exact halves), scales and the
    dequantized cache within 1e-6, the update at ``slot`` in place, and
    ``quant_decode_attention`` within 1e-5."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    x[0, 0] = [127, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5]
    qp, sp = pkv.quantize_kv(torch.from_numpy(x))
    qr, sr = rkv.quantize_kv(jnp.asarray(x))
    assert qp.dtype == torch.int8
    assert np.array_equal(qp.numpy(), np.asarray(qr))
    assert qp[0, 0].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]
    close(f32(sp), f32(sr), 1e-6, 0)
    close(f32(pkv.dequantize_kv(qp, sp)), f32(rkv.dequantize_kv(qr, sr)),
          1e-6, 1e-6)
    pc = pkv.init_quant_cache(2, 2, 6, 3, 8, device="cpu")
    rc = rkv.init_quant_cache(2, 2, 6, 3, 8)
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in rc.items()}
    pl_ = {k: v[1] for k, v in pc.items()}
    rl_ = {k: v[1] for k, v in rc.items()}
    for slot in range(4):
        kn, vn = (rng.standard_normal((2, 3, 8)).astype(np.float32)
                  for _ in range(2))
        pkv.update_quant_cache(pl_, torch.from_numpy(kn),
                               torch.from_numpy(vn), slot)
        rl_ = rkv.update_quant_cache(rl_, jnp.asarray(kn), jnp.asarray(vn),
                                     slot)
    for k in pc:
        assert np.array_equal(f32(pc[k][1]), f32(rl_[k]))
        assert not pc[k][0].any()
    q = rng.standard_normal((2, 6, 8)).astype(np.float32)
    close(f32(pkv.quant_decode_attention(torch.from_numpy(q), pl_, 4)),
          f32(rkv.quant_decode_attention(jnp.asarray(q), rl_, 4)),
          1e-5, 1e-5)


if __name__ == "__main__":
    np.savez(sys.argv[1], **{f"{arch}/{k}": v for arch in sys.argv[2:]
                             for k, v in reference_run(arch,
                                                       "bfloat16").items()})
