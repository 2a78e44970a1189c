"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is ``cuda``-marked and skips (from inside the test) when
torch sees no CUDA device: the kernels have no CPU mode. The module
imports neither jax nor the JAX package, so it also runs where those are
not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.kernels.ops as pops
from repro_torch.core.reordering import blocking_permutation
from repro_torch.core.weights import accel_weights
from repro_torch.graph import WebGraphSpec, generate_webgraph
from repro_torch.graph.structure import Graph
from repro_torch.kernels import bsr_spmm as K
from repro_torch.serve import RankService, RankServiceConfig

TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def loop_inputs(seed, n, v):
    """A service-shaped batch in the blocking permutation's node order."""
    rng = np.random.default_rng(seed)
    n_pad = 1 << max(n, 15).bit_length()
    e = int(rng.integers(2 * n, 6 * n))
    src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    ca, ch, mask, h0 = (np.zeros((n_pad, v)) for _ in range(4))
    for j in range(v):
        m = np.zeros(n_pad)
        m[rng.choice(n, size=max(4, n // 2), replace=False)] = 1.0
        sel = (m[src] > 0) & (m[dst] > 0)
        ca_j, ch_j = accel_weights(np.bincount(dst[sel], minlength=n_pad),
                                   np.bincount(src[sel], minlength=n_pad))
        ca[:, j], ch[:, j], mask[:, j] = ca_j * m, ch_j * m, m
        h0[:, j] = m / m.sum()
    perm = blocking_permutation(src, dst, n_pad)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(n_pad, dtype=perm.dtype)
    vecs = [x[perm] for x in (h0, ca, ch, mask)]
    return Graph(n_pad, inv[src], inv[dst]), vecs


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_k1_matches_plain(cuda, bs, dtype):
    """V 1..20 (column groups past 16), cin shared or per column, with a
    mask: f64 within 1e-13 of max|y| (two summation orders); f32/bf16 both
    round one f64 sum, so within an ulp the row's running sum can carry."""
    rng = np.random.default_rng(bs)
    g = Graph(600, rng.integers(0, 500, 5000), rng.integers(0, 500, 5000))
    p = pops.DeviceBSR.build(g, bs, transpose=True, dtype=dtype, device=cuda)
    tol = {"float64": 1e-13, "float32": 2.0 ** -20, "bfloat16": 2.0 ** -6}
    for v, cc in ((1, 1), (3, 1), (8, 8), (20, 20)):
        x = torch.tensor(rng.random((p.n_pad, v))).to(cuda, TDT[dtype])
        c = torch.tensor(rng.random((p.n_pad, cc))).to(cuda, TDT[dtype])
        mk = torch.tensor(rng.random((p.n_pad, v)) > 0.3).to(cuda, TDT[dtype])
        K.reset_counters()
        y = K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr, x, c, bs=bs,
                                mask=mk)
        assert K.counters.bsr_spmm == math.ceil(v / K.V_GROUP)
        yp = K.bsr_scaled_matvec_plain(p.blocks, p.idx, p.row_ptr, x, c,
                                       bs=bs, mask=mk)
        err = (y.double() - yp.double()).abs().max().item()
        assert err <= tol[dtype] * yp.double().abs().max().item(), (v, err)


@pytest.mark.cuda
def test_k1_rejects_what_it_does_not_take(cuda):
    g = Graph(64, np.arange(63), np.arange(1, 64))
    p = pops.DeviceBSR.build(g, 16, dtype="float64", device=cuda)
    x = torch.ones(p.n_pad, 2, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError):
        K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr, x.float(),
                            x.float()[:, :1], bs=16)  # f32 x, f64 blocks
    with pytest.raises(ValueError):
        K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr, x, x[:, :1], bs=16,
                            accum_dtype="float32")
    with pytest.raises(ValueError):
        K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr, x[::2], x[::2, :1],
                            bs=16)


@pytest.mark.cuda
@pytest.mark.parametrize("rank_k", [0, 5])
def test_epilogue_matches_plain(cuda, rank_k):
    g, vecs = loop_inputs(2, 200, 5)
    h0, ca, ch, m = (torch.tensor(x, device=cuda).contiguous() for x in vecs)
    lt = pops.DeviceBSR.build(g, 32, transpose=True, dtype="float64",
                              device=cuda)
    lf = pops.DeviceBSR.build(g, 32, dtype="float64", device=cuda)
    a = K.bsr_scaled_matvec(*lt.operand, h0, ch, bs=32, mask=m)
    hr = K.bsr_scaled_matvec(*lf.operand, a, ca, bs=32, mask=m)
    outs = []
    for fn in (K.sweep_epilogue, K.sweep_epilogue_plain):
        st = K.LoopState.start(torch.zeros(3, dtype=torch.int32,
                                           device=cuda), 5, rank_k, 100)
        h = h0.clone()
        for _ in range(3):  # the second and third sweeps see unchanged a
            fn(hr, h, a, st, tol=1e-10, stable_sweeps=2, max_iter=100)
        outs.append((h, st))
    (hk, sk), (hp, sp) = outs
    assert (hk - hp).abs().max().item() <= 1e-15
    for f in ("ctl", "conv", "stop", "stab", "top"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    ak, ap = a.clone(), a.clone()
    rk = K.sweep_certificate(hr, hk, ak)
    rp = K.sweep_certificate_plain(hr, hp, ap)
    assert (rk - rp).abs().max().item() <= 1e-15
    assert (ak - ap).abs().max().item() <= 1e-15


@pytest.mark.cuda
@pytest.mark.parametrize("bulk", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("rank_k", [0, 5])
def test_k2_matches_plain(cuda, rank_k, bulk):
    """The device loop vs the plain loop on the card: conv equal, h and a
    within 1e-10 L1, and at most ceil(sweeps/CHUNK) + 1 flag reads."""
    g, vecs = loop_inputs(5, 300, 6)
    args = [torch.tensor(x, device=cuda).contiguous() for x in vecs]
    ops = [pops.DeviceBSR.build(g, 64, transpose=t, dtype="float64",
                                device=cuda) for t in (True, False)]
    kw = dict(bs=64, max_iter=500, rank_k=rank_k)
    if bulk:
        kw.update(lt_lo=ops[0].astype(bulk).operand,
                  lf_lo=ops[1].astype(bulk).operand, bulk_dtype=bulk,
                  bulk_tol=1e3 * torch.finfo(TDT[bulk]).eps)
    K.reset_counters()
    got = K.bsr_converge_cols(ops[0].operand, ops[1].operand, *args, 1e-10,
                              **kw)
    torch.cuda.synchronize()
    counts = K.counters.as_dict()
    want = K.bsr_converge_cols_plain(ops[0].operand, ops[1].operand, *args,
                                     1e-10, **kw)
    assert torch.equal(got[2], want[2]), (got[2], want[2])
    assert (got[0] - want[0]).abs().sum(0).max().item() <= 1e-10
    assert (got[1] - want[1]).abs().sum(0).max().item() <= 1e-10
    assert counts["host_syncs"] <= math.ceil(int(got[2].max()) / K.CHUNK) + 1
    assert counts["bsr_converge"] == 1 and counts["bsr_spmm"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "bsr"])
def test_service_on_the_card_matches_the_cpu(cuda, backend):
    """RankService on the card vs on the CPU: scores within 1e-10 L1,
    equal iters and statuses, over cold, cached and warm batches."""
    g = generate_webgraph(WebGraphSpec(400, 4000, 0.5, seed=2))
    rng = np.random.default_rng(0)
    qs = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(8)]
    out = {}
    for dev in ("cuda", "cpu"):
        svc = RankService(g, RankServiceConfig(device=dev, backend=backend,
                                               v_max=4, rank_k=3,
                                               bsr_block=64))
        out[dev] = svc.rank(qs) + svc.rank(qs[:4]) + svc.rank(qs,
                                                               refresh=True)
    for r, o in zip(out["cuda"], out["cpu"]):
        assert r.status == o.status and r.iters == o.iters
        assert np.abs(r.authority - o.authority).sum() <= 1e-10
        assert np.abs(r.hub - o.hub).sum() <= 1e-10
