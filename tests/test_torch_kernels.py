"""The port's BSR kernels through their plain torch versions (CPU) against
the JAX package's Pallas kernel in interpret mode and its fused loop.

On the CPU every wrapper runs its plain version because its tensors lie on
the CPU; ``tests/test_torch_cuda.py`` holds the CUDA kernels to the same
plain versions on a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels.ops as rops
from repro.graph.structure import Graph as RGraph
from repro.kernels.bsr_spmm import bsr_scaled_matvec as r_k1
from repro.kernels.ref import bsr_scaled_matvec_ref as r_oracle
from repro.sparse.spmv import spmv_dst as r_spmv_dst
import repro_torch.kernels.ops as pops
from repro_torch.graph import from_reference
from repro_torch.kernels import bsr_spmm as K
from repro_torch.kernels.ref import bsr_scaled_matvec_ref as p_oracle

ROOT = Path(__file__).resolve().parents[1]
TDT = {"float64": torch.float64, "float32": torch.float32,
       "bfloat16": torch.bfloat16}
JDT = {"float64": jnp.float64, "float32": jnp.float32,
       "bfloat16": jnp.bfloat16}


def rand_graph(n, e, seed, tail_empty=0):
    """Random graph; the last ``tail_empty`` nodes get no edges, so whole
    block rows stay empty."""
    rng = np.random.default_rng(seed)
    hi = n - tail_empty
    return RGraph(n, rng.integers(0, hi, e), rng.integers(0, hi, e))


def both_ops(g, bs, dtype, transpose=True, values=None):
    r = rops.DeviceBSR.build(g, bs, transpose=transpose, dtype=JDT[dtype],
                             values=values)
    p = pops.DeviceBSR.build(from_reference(g), bs, transpose=transpose,
                             dtype=dtype, values=values, device="cpu")
    return r, p


def k1_pair(g, bs, dtype, v, cin_cols, seed):
    r, p = both_ops(g, bs, dtype)
    rng = np.random.default_rng(seed)
    x = rng.random((r.n_pad, v))
    cin = rng.random((r.n_pad, cin_cols))
    accum = jnp.float64 if dtype == "float64" else jnp.float32
    y_ref = r_k1(r.blocks, r.idx, jnp.asarray(x, JDT[dtype]),
                 jnp.asarray(cin, JDT[dtype]), bs=bs, interpret=True,
                 accum_dtype=accum)
    y = K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr,
                            torch.tensor(x).to(TDT[dtype]),
                            torch.tensor(cin).to(TDT[dtype]), bs=bs)
    return (np.asarray(y_ref.astype(jnp.float32 if dtype == "bfloat16"
                                    else y_ref.dtype)),
            y.float().numpy() if dtype == "bfloat16" else y.numpy())


@pytest.mark.parametrize("bs", [16, 64])
@pytest.mark.parametrize("v,cin_cols", [(1, 1), (4, 1), (8, 8)])
def test_k1_plain_matches_pallas_f64_f32(bs, v, cin_cols):
    """f64 at rtol 1e-13 (the reference's own f64 pin: sums of the same
    products in another order); f32 at rtol 1e-6 (f32 sums of <= 64
    products per block, ~8 rows of blocks, in another order)."""
    g = rand_graph(200, 1600, seed=bs + v, tail_empty=40)
    for dtype, rtol in (("float64", 1e-13), ("float32", 1e-6)):
        y_ref, y = k1_pair(g, bs, dtype, v, cin_cols, seed=v)
        assert y.dtype == y_ref.dtype
        np.testing.assert_allclose(y, y_ref, rtol=rtol,
                                   atol=rtol * np.abs(y_ref).max())


@pytest.mark.parametrize("bs", [16, 32])
def test_k1_plain_matches_pallas_bf16(bs):
    """bf16 compared in f32, within 2 bf16 ulps (2^-7 relative): XLA on
    the CPU keeps excess precision by default and skips the two bf16
    roundings the Pallas source writes (x*cin, and each block's product
    before it joins the row's bf16 sum), which the port performs. The
    bit-exact check with excess precision off is the next test."""
    g = rand_graph(200, 1600, seed=bs, tail_empty=40)
    y_ref, y = k1_pair(g, bs, "bfloat16", 6, 6, seed=1)
    np.testing.assert_allclose(y, y_ref, rtol=2.0 ** -7,
                               atol=2.0 ** -7 * np.abs(y_ref).max())


def test_k1_plain_bf16_bit_exact_without_excess_precision(oracle):
    """With XLA's excess precision off the reference rounds where its
    source says, and the port's bf16 K1 equals it bit for bit."""
    for bs in (16, 32):
        g = rand_graph(200, 1600, seed=bs, tail_empty=40)
        _, p = both_ops(g, bs, "bfloat16")
        x, c = bf16_inputs(p.n_pad)
        y = K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr,
                                torch.tensor(x).bfloat16(),
                                torch.tensor(c).bfloat16(), bs=bs)
        assert np.array_equal(y.float().numpy(), oracle[f"k1/{bs}"]), bs


def dense_row_graph():
    """256 nodes in blocks of 32: nodes 64-95 link to and from nodes of
    every block but the last, and nothing else links: in either
    orientation block row 2 holds 7 blocks and every other row one (the
    last a padding block)."""
    rng = np.random.default_rng(30)
    hub = rng.integers(64, 96, 600)
    far = rng.integers(0, 224, 600)
    return RGraph(256, np.concatenate([hub, far]), np.concatenate([far, hub]))


@pytest.mark.parametrize("transpose", [True, False])
def test_k1_plain_dense_block_row_matches_pallas(transpose):
    """The plain K1 (the kernel's twin) on an operator with one dense
    block row, against the Pallas kernel in interpret mode: f64 at rtol
    1e-13, f32 at rtol 1e-6 (as above)."""
    g = dense_row_graph()
    for dtype, rtol in (("float64", 1e-13), ("float32", 1e-6)):
        r, p = both_ops(g, 32, dtype, transpose=transpose)
        counts = np.diff(p.row_ptr.numpy())
        assert counts.max() == 7 and (counts == 1).sum() >= 5
        rng = np.random.default_rng(4)
        x, cin = rng.random((r.n_pad, 5)), rng.random((r.n_pad, 5))
        y_ref = r_k1(r.blocks, r.idx, jnp.asarray(x, JDT[dtype]),
                     jnp.asarray(cin, JDT[dtype]), bs=32, interpret=True,
                     accum_dtype=jnp.float64 if dtype == "float64"
                     else jnp.float32)
        y = K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr,
                                torch.tensor(x).to(TDT[dtype]),
                                torch.tensor(cin).to(TDT[dtype]), bs=32)
        np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=rtol,
                                   atol=rtol * np.abs(np.asarray(y_ref)).max())


def test_k1_plain_dense_block_row_bf16_bit_exact(oracle):
    """bf16 on the dense block row, bit for bit against the reference
    run without XLA's excess precision."""
    _, p = both_ops(dense_row_graph(), 32, "bfloat16")
    x, c = bf16_inputs(p.n_pad)
    y = K.bsr_scaled_matvec(p.blocks, p.idx, p.row_ptr,
                            torch.tensor(x).bfloat16(),
                            torch.tensor(c).bfloat16(), bs=32)
    assert np.array_equal(y.float().numpy(), oracle["k1dense"])


def test_k1_scratch_sizes_and_reserve():
    """K1's workspace holds every block's (vt, bs) product in y's dtype
    (vt: V rounded up to a power of two, at most 16 per launch); one fold
    counter per block row and 32-row slice. ``Scratch.reserve`` grows,
    never shrinks, and its counters start at 0; ``Scratch.on`` refuses a
    scratch on another device."""
    assert K.K1_ROWS == 32
    assert K.k1_scratch_sizes(350, 32, 128, 8, 8) == (350 * 128 * 8 * 8,
                                                      32 * 4)
    assert K.k1_scratch_sizes(10, 7, 16, 3, 2) == (10 * 16 * 4 * 2, 7)
    assert K.k1_scratch_sizes(10, 7, 64, 20, 4) == (10 * 64 * 16 * 4, 14)
    scr = K.Scratch("cpu")
    assert scr.ws.numel() == 0 and scr.cnt.numel() == 0
    scr.reserve(100, 5)
    ws, cnt = scr.ws, scr.cnt
    assert ws.numel() == 100 and cnt.dtype == torch.int32
    assert not cnt.any()
    scr.reserve(50, 3)
    assert scr.ws is ws and scr.cnt is cnt
    scr.reserve(200, 9)
    assert scr.ws.numel() == 200 and scr.cnt.numel() == 9
    assert K.Scratch.on("cpu", scr) is scr
    assert K.Scratch.on("cpu").ws.numel() == 0
    with pytest.raises(ValueError):
        K.Scratch.on("meta", scr)


def test_oracle_matches_reference_oracle():
    """``kernels.ref`` computes in f32 like the reference's oracle."""
    g = rand_graph(150, 900, seed=3)
    r, p = both_ops(g, 32, "float32")
    rng = np.random.default_rng(2)
    x, cin = rng.random((r.n_pad, 3)), rng.random((r.n_pad, 3))
    y_ref = r_oracle(r.blocks, r.idx, jnp.asarray(x), jnp.asarray(cin),
                     r.n_pad)
    y = p_oracle(p.blocks, p.idx, torch.tensor(x), torch.tensor(cin), p.n_pad)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-6)


def test_device_bsr_layout_and_pad_empty_rows_equal():
    """Block values, idx tables and padded rows are the reference's, and
    row_ptr is the CSR pointer of idx."""
    g = RGraph(100, np.array([0, 1], np.int32), np.array([99, 98], np.int32))
    for transpose in (True, False):
        r, p = both_ops(g, 16, "float64", transpose=transpose)
        assert p.n_pad == r.n_pad == 112 and p.n_nodes == 100
        assert np.array_equal(np.asarray(r.idx), p.idx.numpy())
        assert np.array_equal(np.asarray(r.blocks), p.blocks.numpy())
        counts = np.bincount(p.idx[:, 0].numpy(), minlength=7)
        assert np.array_equal(np.diff(p.row_ptr.numpy()), counts)
        assert (counts >= 1).all()
    gb = rand_graph(300, 900, seed=8, tail_empty=120)
    from repro.graph.structure import to_bsr as r_to_bsr
    from repro_torch.graph.structure import to_bsr as p_to_bsr
    rb = rops.pad_empty_rows(r_to_bsr(gb, 32))
    pb = pops.pad_empty_rows(p_to_bsr(from_reference(gb), 32))
    for f in ("blocks", "brow", "bcol", "row_ptr"):
        assert np.array_equal(getattr(rb, f), getattr(pb, f)), f


def test_bsr_revalue_equal():
    g = rand_graph(120, 700, seed=4)
    r, _ = both_ops(g, 32, "float64")
    w = np.random.default_rng(3).random(g.n_edges)
    gr = g.reverse()
    args = (np.asarray(r.idx), 32, r.n_pad, gr.src, gr.dst, w)
    assert np.array_equal(rops.bsr_revalue(*args), pops.bsr_revalue(*args))
    bad = (np.asarray(r.idx)[:-1], 32, r.n_pad, gr.src, gr.dst, w)
    assert rops.bsr_revalue(*bad) is None and pops.bsr_revalue(*bad) is None


@pytest.mark.parametrize("squeeze", [False, True])
def test_bsr_matvec_matches_reference(squeeze):
    """Uneven tail (100 nodes pad to 112) and per-column or shared cin,
    f64 at the reference's rtol 1e-13."""
    g = rand_graph(100, 500, seed=6)
    r, p = both_ops(g, 16, "float64")
    rng = np.random.default_rng(4)
    x = rng.random(100) if squeeze else rng.random((100, 4))
    cin = rng.random(100)
    y_ref = rops.bsr_matvec(r, jnp.asarray(x), jnp.asarray(cin),
                            interpret=True, accum_dtype=jnp.float64)
    y = pops.bsr_matvec(p, torch.tensor(x), torch.tensor(cin))
    assert y.shape == x.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-13,
                               atol=1e-15)


def test_f64_edge_values_not_quantized():
    """Generic f64 edge weights reach the blocks unrounded (rtol 1e-13
    against the edge-list product, as the reference pins)."""
    g = rand_graph(180, 1400, seed=17)
    w = np.random.default_rng(1).random(g.n_edges)
    _, p = both_ops(g, 32, "float64", values=w)
    assert p.blocks.dtype == torch.float64
    x = np.random.default_rng(2).random((g.n_nodes, 3))
    y = pops.bsr_matvec(p, torch.tensor(x))
    y_ref = r_spmv_dst(jnp.asarray(x), jnp.asarray(g.src), jnp.asarray(g.dst),
                       g.n_nodes, jnp.asarray(w))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-13,
                               atol=1e-14)


# ------------------------------------------------------------------- K2
#
# The reference results for the loop tests (and the bf16 K1 check) come
# from one subprocess that runs this file as a script with
# --xla_allow_excess_precision=false: XLA on the CPU otherwise keeps excess
# precision and skips bf16 roundings the Pallas source writes, which the
# port performs.


def loop_inputs(seed, n, v):
    """A service-shaped batch in the operators' permuted space: random
    graph, per-column base-set masks, induced accel weights, uniform
    starts; plus the blocking permutation and its inverse."""
    from repro.core.weights import accel_weights
    from repro.core.reordering import blocking_permutation
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
    g = RGraph(n_pad, inv[src], inv[dst])
    return g, (h0, ca, ch, mask), perm, inv


def run_reference_loop(g, vecs, perm, inv, bs, rank_k, bulk, tol, max_iter):
    lt = rops.DeviceBSR.build(g, bs, transpose=True, dtype=jnp.float64)
    lf = rops.DeviceBSR.build(g, bs, transpose=False, dtype=jnp.float64)
    lo = {}
    if bulk:
        bd = JDT[bulk]
        lo = dict(lt_lo=rops.DeviceBSR(lt.blocks.astype(bd), lt.idx, bs,
                                       lt.n_nodes, lt.n_pad),
                  lfwd_lo=rops.DeviceBSR(lf.blocks.astype(bd), lf.idx, bs,
                                         lf.n_nodes, lf.n_pad),
                  bulk_dtype=bulk,
                  bulk_tol=max(tol, 1e3 * float(jnp.finfo(bd).eps)))
    out = rops.bsr_converge(lt, lf, *(jnp.asarray(x) for x in vecs), tol,
                            max_iter, interpret=True,
                            accum_dtype=jnp.float64, perm=jnp.asarray(perm),
                            inv=jnp.asarray(inv), rank_k=rank_k, **lo)
    return [np.asarray(x) for x in out]


def bf16_inputs(n_pad):
    rng = np.random.default_rng(0)
    return rng.random((n_pad, 5)), rng.random((n_pad, 5))


def compute_oracle(path):
    import jax
    jax.config.update("jax_enable_x64", True)
    out = {}
    for bs in (16, 32):
        g = rand_graph(200, 1600, seed=bs, tail_empty=40)
        r, _ = both_ops(g, bs, "bfloat16")
        x, c = bf16_inputs(r.n_pad)
        out[f"k1/{bs}"] = np.asarray(r_k1(
            r.blocks, r.idx, jnp.asarray(x, jnp.bfloat16),
            jnp.asarray(c, jnp.bfloat16), bs=bs,
            interpret=True).astype(jnp.float32))
    r, _ = both_ops(dense_row_graph(), 32, "bfloat16")
    x, c = bf16_inputs(r.n_pad)
    out["k1dense"] = np.asarray(r_k1(
        r.blocks, r.idx, jnp.asarray(x, jnp.bfloat16),
        jnp.asarray(c, jnp.bfloat16), bs=32,
        interpret=True).astype(jnp.float32))
    runs = {f"k2/{s}/{b}/{k}": (s, 50 + 9 * s, 1 + 2 * s, k, b, 1e-10, 200)
            for s in (0, 2) for b in (None, "bfloat16") for k in (0, 5)}
    runs.update({f"k2f/{s}/{k}": (s, 60, 3, k, "float32", 1e-10, 200)
                 for s in (3,) for k in (0, 5)})
    runs["k2max"] = (3, 60, 3, 0, None, 1e-300, 7)
    for key, (seed, n, v, rank_k, bulk, tol, max_iter) in runs.items():
        g, vecs, perm, inv = loop_inputs(seed, n, v)
        res = run_reference_loop(g, vecs, perm, inv, 32, rank_k, bulk, tol,
                                 max_iter)
        for i, x in enumerate(res):
            out[f"{key}/{i}"] = x
    np.savez(path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("k2_oracle") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    out = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def run_port_loop(g, vecs, perm, inv, bs, rank_k, bulk, tol, max_iter):
    pg_ = from_reference(g)
    lt = pops.DeviceBSR.build(pg_, bs, transpose=True, dtype="float64",
                              device="cpu")
    lf = pops.DeviceBSR.build(pg_, bs, transpose=False, dtype="float64",
                              device="cpu")
    lo = {}
    if bulk:
        lo = dict(lt_lo=lt.astype(bulk), lfwd_lo=lf.astype(bulk),
                  bulk_dtype=bulk,
                  bulk_tol=max(tol, 1e3 * torch.finfo(TDT[bulk]).eps))
    out = pops.bsr_converge(lt, lf, *(torch.tensor(x) for x in vecs), tol,
                            max_iter, perm=torch.tensor(perm).long(),
                            inv=torch.tensor(inv).long(), rank_k=rank_k, **lo)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("rank_k", [0, 5])
@pytest.mark.parametrize("bulk", [None, "bfloat16"])
@pytest.mark.parametrize("seed", [0, 2])
def test_k2_plain_matches_reference_loop(oracle, seed, bulk, rank_k):
    """f64 polish, ladder off or bf16, with perm/inv: h and a within 1e-10
    L1 and conv equal, against the reference run without XLA's excess
    precision (with it, the bf16 phase's vectors differ in bf16 ulps, and
    where the rank rule publishes before the f64 phase has contracted
    that away, so do the results)."""
    g, vecs, perm, inv = loop_inputs(seed, 50 + 9 * seed, 1 + 2 * seed)
    want = [oracle[f"k2/{seed}/{bulk}/{rank_k}/{i}"] for i in range(4)]
    got = run_port_loop(g, vecs, perm, inv, 32, rank_k, bulk, 1e-10, 200)
    assert np.array_equal(got[2], want[2]), (got[2], want[2])
    assert np.abs(got[0] - want[0]).sum(axis=0).max() <= 1e-10
    assert np.abs(got[1] - want[1]).sum(axis=0).max() <= 1e-10
    # res measures a movement of ~tol; h that agree to ~1e-13 L1 give
    # certificates that agree to ~1e-12
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-12)


@pytest.mark.parametrize("rank_k", [0, 5])
def test_k2_plain_fp32_ladder_against_reference(oracle, rank_k):
    """fp32 ladder. The bulk phase sums f32 in an order XLA and torch each
    choose (neither is sequential), so its vectors differ in the last f32
    bits, and the reference's own backends (dense vs bsr, fused vs host
    loop) differ from each other by one sweep on such batches. Held to:
    conv within one sweep; with rank_k=0 (published at the f64 residual)
    h and a within 1e-10 L1; with rank_k>0 the rank rule publishes
    unconverged vectors that still carry the f32 differences, contracted
    by only a few f64 sweeps: within 1e-6 L1."""
    for seed in (3,):
        g, vecs, perm, inv = loop_inputs(seed, 60, 3)
        want = [oracle[f"k2f/{seed}/{rank_k}/{i}"] for i in range(4)]
        got = run_port_loop(g, vecs, perm, inv, 32, rank_k, "float32",
                            1e-10, 200)
        assert np.abs(got[2].astype(int) - want[2].astype(int)).max() <= 1
        l1 = 1e-10 if rank_k == 0 else 1e-6
        assert np.abs(got[0] - want[0]).sum(axis=0).max() <= l1
        assert np.abs(got[1] - want[1]).sum(axis=0).max() <= l1


def test_k2_stops_at_max_iter(oracle):
    """An unreachable tolerance: every column runs exactly max_iter sweeps
    in both, with the same (unconverged) vectors."""
    g, vecs, perm, inv = loop_inputs(3, 60, 3)
    want = [oracle[f"k2max/{i}"] for i in range(4)]
    got = run_port_loop(g, vecs, perm, inv, 32, 0, None, 1e-300, 7)
    assert (got[2] == 7).all() and (want[2] == 7).all()
    assert np.abs(got[0] - want[0]).sum() <= 1e-12
    assert np.abs(got[1] - want[1]).sum() <= 1e-12


def rehearse_against_plain(rank_k, bulk, max_iter, seed=7):
    """K2's graph rehearsed on the CPU (``k2_rehearse``: the step list the
    builder captures, interpreted with the plain versions, each WHILE
    testing its condition before every iteration) against the plain
    per-sweep loop: equal bit for bit, and the steps ran as often as the
    card launches them (K1 twice per sweep and for the certificate).
    Returns the steps run per (op, phase)."""
    g, vecs, perm, inv = loop_inputs(seed, 70, 4)
    pg_ = from_reference(g)
    lt = pops.DeviceBSR.build(pg_, 32, transpose=True, dtype="float64",
                              device="cpu")
    lf = pops.DeviceBSR.build(pg_, 32, transpose=False, dtype="float64",
                              device="cpu")
    args = [torch.tensor(x).index_select(0, torch.tensor(perm).long())
            .contiguous() for x in vecs]
    lo = (None, None) if bulk is None else (lt.astype(bulk).operand,
                                            lf.astype(bulk).operand)
    bulk_tol = 0.0 if bulk is None else max(1e-10, 1e3 * torch.finfo(
        TDT[bulk]).eps)
    kw = dict(bs=32, max_iter=max_iter, rank_k=rank_k, lt_lo=lo[0],
              lf_lo=lo[1], bulk_tol=bulk_tol, bulk_dtype=bulk)
    common = (lt.operand, lf.operand, *args, 1e-10)
    plain = K.bsr_converge_cols_plain(*common, **kw)
    K.reset_counters()
    got, runs = K.k2_rehearse(*common, **kw)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    # the last column to stop (or every column at max_iter) holds k
    k = int(plain[2].max())
    count = {op: sum(n for (o, _), n in runs.items() if o == op)
             for op in ("spmm", "epilogue", "reset", "finish",
                        "certificate")}
    assert count["spmm"] == 2 * (k + 1) and count["epilogue"] == k
    assert count["certificate"] == count["finish"] == 1
    assert count["reset"] == (2 if bulk else 1)
    assert K.counters.as_dict() == dict.fromkeys(K.counters.as_dict(), 0)
    return runs, k


@pytest.mark.parametrize("bulk", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("rank_k", [0, 4])
def test_chunked_device_loop_equals_plain_loop(rank_k, bulk):
    """The graph's step list, rehearsed with the plain versions, equals
    the plain loop (see ``rehearse_against_plain``)."""
    _, k = rehearse_against_plain(rank_k, bulk, 300)
    assert 0 < k < 300


@pytest.mark.parametrize("case,bulk", [
    ("max_iter 0", None), ("max_iter 0", "bfloat16"),
    ("bulk phase", "bfloat16"), ("bulk phase", "float32"),
    ("mid-phase", None), ("mid-phase", "float32")])
def test_device_loop_rehearsal_at_max_iter(case, bulk):
    """Where max_iter cuts the loop: at 0 no WHILE body runs and the
    certificate still does; used up by the ladder's bulk phase, the
    full-precision WHILE runs no sweep (its condition is tested before
    the first iteration); cut in the middle of the last phase, k ends at
    max_iter."""
    free, k_free = rehearse_against_plain(4, bulk, 300)
    bulk_sweeps = free.get(("epilogue", "lo"), 0)
    if case == "max_iter 0":
        max_iter = 0
    elif case == "bulk phase":
        max_iter = max(1, bulk_sweeps - 1)
    else:
        assert free[("epilogue", "hi")] >= 2
        max_iter = k_free - 1
    runs, k = rehearse_against_plain(4, bulk, max_iter)
    assert k == max_iter
    if case != "mid-phase":
        assert runs.get(("epilogue", "hi"), 0) == 0


def test_wrappers_count_nothing_on_the_cpu():
    """On CPU tensors the wrappers run their plain versions: no kernel
    launch is counted."""
    g, vecs, perm, inv = loop_inputs(1, 40, 2)
    K.reset_counters()
    run_port_loop(g, vecs, perm, inv, 16, 0, None, 1e-10, 50)
    assert K.counters.as_dict() == {"bsr_spmm": 0, "bsr_spmm_bytes": 0,
                                    "k1_links": 0, "sweep_epilogue": 0,
                                    "bsr_converge": 0, "host_syncs": 0,
                                    "k2_graph_builds": 0, "seg_matmul": 0}


if __name__ == "__main__":
    compute_oracle(sys.argv[1])
