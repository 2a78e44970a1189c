"""The port's CUDA kernels against their plain torch versions, on a card.

Every test here is ``cuda``-marked and skips (from inside the test) when
torch sees no CUDA device: the kernels have no CPU mode. The module
imports neither jax nor the JAX package, so it also runs where those are
not installed:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda.py
"""
import gc
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
from repro_torch.serve import (PipelineJob, RankService, RankServiceConfig,
                               make_backend)

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
@pytest.mark.parametrize("rank_k", [0, 5, 10])
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
        st = K.LoopState.start(torch.zeros(2, dtype=torch.int32,
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
    rk = K.sweep_certificate(hr, hk, ak, sk.ep)  # on the loop's workspace
    rp = K.sweep_certificate_plain(hr, hp, ap)
    assert not sk.ep.cnt.any()
    assert (rk - rp).abs().max().item() <= 1e-15
    assert (ak - ap).abs().max().item() <= 1e-15


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
@pytest.mark.parametrize("n,v,rank_k", [(1000, 5, 10), (4096, 8, 10),
                                        (40, 20, 10), (20001, 3, 10),
                                        (1000, 5, 40)])
def test_epilogue_ties_and_ragged_slices(cuda, n, v, rank_k, dtype):
    """The row-sliced epilogue on n rows that are not a multiple of its
    slice (1000, 40 and 20001 rows, in slices of 16 and 160 rows) and on a
    V that splits its 16-byte loads unevenly (3, 5, 20), with ``a`` full of
    exact ties across and inside slices (values from a set of 4, every
    other slice a copy of the one before): the slices' top-k lists (rows
    past a lane's 4 in registers read from memory in slices of 160 rows)
    merge to the plain version's stable sort at rank_k 10 and 40; h within
    1e-15 (f64) or an ulp (bf16), ctl/conv/stop/stab/top equal over four
    sweeps, the counter back at 0."""
    rng = np.random.default_rng(n + v)
    rows, slices = K.ep_slicing(n)
    assert n % rows or n == 4096
    dt = TDT[dtype]
    hr = torch.tensor(rng.random((n, v))).to(cuda, dt)
    a = torch.tensor(rng.integers(0, 4, (n, v)) / 4.0).to(cuda, dt)
    for s in range(1, slices, 2):  # equal slices: ties across slices too
        a[s * rows:(s + 1) * rows] = a[(s - 1) * rows:s * rows][
            :max(0, min(rows, n - s * rows))]
    h0 = torch.tensor(rng.random((n, v))).to(cuda, dt)
    outs = []
    for fn in (K.sweep_epilogue, K.sweep_epilogue_plain):
        st = K.LoopState.start(torch.zeros(2, dtype=torch.int32,
                                           device=cuda), v, rank_k, 100)
        h = h0.clone()
        for _ in range(4):
            fn(hr, h, a, st, tol=1e-10, stable_sweeps=2, max_iter=100)
        outs.append((h, st))
    (hk, sk), (hp, sp) = outs
    ulp = 1e-15 if dtype == "float64" else 2.0 ** -8
    assert (hk.double() - hp.double()).abs().max().item() <= ulp
    for f in ("ctl", "conv", "stop", "stab", "top"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    assert not sk.ep.cnt.any()
    ak, ap = a.clone(), a.clone()
    rk = K.sweep_certificate(hr, hk, ak)
    rp = K.sweep_certificate_plain(hr, hk, ap)
    assert (rk - rp).abs().max().item() <= ulp * max(1.0, rp.abs().max()
                                                     .item())
    assert (ak.double() - ap.double()).abs().max().item() <= ulp


@pytest.mark.cuda
@pytest.mark.parametrize("bulk", [None, "bfloat16", "float32"])
@pytest.mark.parametrize("rank_k", [0, 5])
def test_k2_matches_plain(cuda, rank_k, bulk):
    """The K2 graph vs the plain loop on the card: conv equal, h and a
    within 1e-10 L1, one graph build, one host read, and K1 and the
    epilogue launched 2 × (sweeps + 1) times, as the kernels counted
    themselves on the device."""
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
    k = int(want[2].max())
    assert counts["host_syncs"] == 1 and counts["k2_graph_builds"] == 1
    assert counts["bsr_converge"] == 1
    assert counts["bsr_spmm"] == counts["sweep_epilogue"] == 2 * (k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("max_iter", [0, 1, 3])
def test_k2_graph_at_max_iter(cuda, max_iter):
    """max_iter 0 runs no sweep (the WHILE condition is tested before the
    first iteration), 1 uses the budget up in the bf16 bulk phase (the
    full-precision WHILE runs none), 3 cuts the full-precision phase: conv
    equal to the plain loop, h and a within 1e-10 L1."""
    g, vecs = loop_inputs(6, 300, 4)
    args = [torch.tensor(x, device=cuda).contiguous() for x in vecs]
    ops = [pops.DeviceBSR.build(g, 32, transpose=t, dtype="float64",
                                device=cuda) for t in (True, False)]
    kw = dict(bs=32, max_iter=max_iter, rank_k=3,
              lt_lo=ops[0].astype("bfloat16").operand,
              lf_lo=ops[1].astype("bfloat16").operand,
              bulk_dtype="bfloat16", bulk_tol=1e3 * 2.0 ** -7)
    K.reset_counters()
    got = K.bsr_converge_cols(ops[0].operand, ops[1].operand, *args, 1e-10,
                              **kw)
    want = K.bsr_converge_cols_plain(ops[0].operand, ops[1].operand, *args,
                                     1e-10, **kw)
    assert torch.equal(got[2], want[2]) and (got[2] == max_iter).any()
    assert (got[0] - want[0]).abs().sum(0).max().item() <= 1e-10
    assert (got[1] - want[1]).abs().sum(0).max().item() <= 1e-10
    assert K.counters.bsr_spmm == 2 * (max_iter + 1)


@pytest.mark.cuda
def test_k2_wide_batch_column_groups(cuda):
    """V 20: K1 runs as two column groups inside the graph and the
    epilogue's 16-byte loads straddle rows; conv equal to the plain loop,
    h and a within 1e-10 L1, K1 launched 2 × 2 × (sweeps + 1) times."""
    g, vecs = loop_inputs(9, 300, 20)
    args = [torch.tensor(x, device=cuda).contiguous() for x in vecs]
    ops = [pops.DeviceBSR.build(g, 64, transpose=t, dtype="float64",
                                device=cuda).operand for t in (True, False)]
    kw = dict(bs=64, max_iter=300, rank_k=3)
    K.reset_counters()
    got = K.bsr_converge_cols(*ops, *args, 1e-10, **kw)
    want = K.bsr_converge_cols_plain(*ops, *args, 1e-10, **kw)
    assert torch.equal(got[2], want[2])
    assert (got[0] - want[0]).abs().sum(0).max().item() <= 1e-10
    assert (got[1] - want[1]).abs().sum(0).max().item() <= 1e-10
    assert K.counters.bsr_spmm == 4 * (int(want[2].max()) + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("bulk", [None, "float32"])
def test_k1_and_k2_count_the_operator_bytes(cuda, bulk):
    """``bsr_spmm_bytes`` is each K1 launch's operator (blocks, idx and
    row_ptr) summed over the launches: for direct K1 over two column
    groups, and for one K2 call, whose K1 launches in each phase read that
    phase's Lᵀ and L in turn, as often as the CPU rehearsal of its graph
    runs them."""
    g, vecs = loop_inputs(5, 300, 6)
    ops = [pops.DeviceBSR.build(g, 64, transpose=t, dtype="float64",
                                device=cuda) for t in (True, False)]
    size = lambda o: sum(t.numel() * t.element_size()  # noqa: E731
                         for t in (o.blocks, o.idx, o.row_ptr))
    assert ops[0].operand.nbytes == size(ops[0]) \
        == ops[0].blocks.shape[0] * (64 * 64 * 8 + 2 * 4) \
        + ops[0].row_ptr.numel() * 4
    x = torch.rand(ops[0].n_pad, 20, dtype=torch.float64, device=cuda)
    K.reset_counters()
    K.bsr_scaled_matvec(ops[0].blocks, ops[0].idx, ops[0].row_ptr, x,
                        x[:, :1].contiguous(), bs=64)
    assert K.counters.bsr_spmm == 2
    assert K.counters.bsr_spmm_bytes == 2 * size(ops[0])
    args = [torch.tensor(v, device=cuda).contiguous() for v in vecs]
    kw = dict(bs=64, max_iter=500, rank_k=0)
    lo = []
    if bulk:
        lo = [o.astype(bulk) for o in ops]
        kw.update(lt_lo=lo[0].operand, lf_lo=lo[1].operand, bulk_dtype=bulk,
                  bulk_tol=1e3 * torch.finfo(TDT[bulk]).eps)
    K.reset_counters()
    K.bsr_converge_cols(ops[0].operand, ops[1].operand, *args, 1e-10, **kw)
    counts = K.counters.as_dict()
    cpu = lambda o: K.BsrOperand(*(t.cpu() for t in o))  # noqa: E731
    kw_cpu = dict(kw, **({"lt_lo": cpu(kw["lt_lo"]),
                          "lf_lo": cpu(kw["lf_lo"])} if bulk else {}))
    _got, runs = K.k2_rehearse(cpu(ops[0].operand), cpu(ops[1].operand),
                               *(a.cpu() for a in args), 1e-10, **kw_cpu)
    hi, lo_runs = runs[("spmm", "hi")], runs.get(("spmm", "lo"), 0)
    assert counts["bsr_spmm"] == hi + lo_runs
    want = hi // 2 * (size(ops[0]) + size(ops[1]))
    if bulk:
        assert lo_runs > 0
        want += lo_runs // 2 * (size(lo[0]) + size(lo[1]))
    assert counts["bsr_spmm_bytes"] == want


@pytest.mark.cuda
def test_k2_each_call_builds_and_frees_its_graph(cuda):
    """Each call builds its own graph over its own buffers: a second call
    with another h0 and tol builds again, both match the plain loop, a
    repeat gives the same bits, and once the results are dropped every
    byte of device memory the calls took is back."""
    g, vecs = loop_inputs(10, 300, 6)
    args = [torch.tensor(x, device=cuda).contiguous() for x in vecs]
    ops = [pops.DeviceBSR.build(g, 64, transpose=t, dtype="float64",
                                device=cuda).operand for t in (True, False)]
    kw = dict(bs=64, max_iter=300, rank_k=5)
    h1 = torch.softmax(args[0] * 3.0, dim=0) * args[3]
    torch.cuda.synchronize()
    gc.collect()
    base = torch.cuda.memory_allocated(cuda)
    K.reset_counters()
    first = K.bsr_converge_cols(*ops, *args, 1e-10, **kw)
    second = K.bsr_converge_cols(*ops, h1, *args[1:], 1e-8, **kw)
    repeat = K.bsr_converge_cols(*ops, h1, *args[1:], 1e-8, **kw)
    assert K.counters.k2_graph_builds == 3 and K.counters.host_syncs == 3
    for x, y in zip(second, repeat):
        assert torch.equal(x, y)
    for got, h, tol in ((first, args[0], 1e-10), (second, h1, 1e-8)):
        want = K.bsr_converge_cols_plain(*ops, h, *args[1:], tol, **kw)
        assert torch.equal(got[2], want[2])
        assert (got[0] - want[0]).abs().sum(0).max().item() <= 1e-10
    del first, second, repeat, got, want, x, y
    gc.collect()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) <= base


def bsr_batches(cuda):
    """A bsr backend, a batch of 4 queries and the same batch after a
    weight-only delta (20 of its union's edges reweighted by 2.0)."""
    g = generate_webgraph(WebGraphSpec(900, 9000, 0.4, seed=4))
    rng = np.random.default_rng(2)
    qs = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(4)]
    svc = RankService(g, RankServiceConfig(device="cuda", backend="bsr",
                                           v_max=4, bsr_block=64))
    job = PipelineJob(queries=[svc.validate_roots(q) for q in qs],
                      refresh=True)
    pre = svc.pipeline.assemble(job).batch
    fs = svc.extractor.extract_union([svc.extractor.extract(q) for q in qs])
    pick = np.random.default_rng(5).choice(fs.graph.n_edges, 20,
                                           replace=False)
    svc.apply_edge_delta(reweights=[
        (int(fs.nodes[fs.graph.src[i]]), int(fs.nodes[fs.graph.dst[i]]), 2.0)
        for i in pick])
    post = svc.pipeline.assemble(job).batch
    return make_backend("bsr", bsr_block=64, device=cuda), pre, post


@pytest.mark.cuda
def test_k2_patched_plan_sweeps_through_a_graph(cuda):
    """A plan's repeat sweeps give the same bits (a graph each); a plan
    patched after a weight-only delta sweeps through a graph over its new
    blocks and matches the CPU backend on the same batch."""
    be, pre, post = bsr_batches(cuda)
    plan = be.plan(pre)
    K.reset_counters()
    first = be.sweep(plan, pre)
    repeat = be.sweep(plan, pre)
    assert K.counters.k2_graph_builds == 2 and K.counters.host_syncs == 2
    for x, y in zip(first, repeat):
        assert np.array_equal(x, y)
    patched = be.patch(plan, post)
    assert patched is not None
    got = be.sweep(patched, post)
    assert K.counters.k2_graph_builds == 3
    cpu = make_backend("bsr", bsr_block=64, device="cpu")
    want = cpu.sweep(cpu.plan(post), post)
    assert np.array_equal(got[2], want[2])
    assert np.abs(got[0] - want[0]).sum(axis=0).max() <= 1e-10
    assert np.abs(got[1] - want[1]).sum(axis=0).max() <= 1e-10


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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("accum", ["float32", "float64"])
def test_k3_matches_plain(cuda, dtype, accum):
    """K3 on the card equals its plain version (run on the card) bit for
    bit: widths 1, 8 and 40 (two column chunks), block sizes 32 and 128,
    tiles of 64 and 256 slots, destination blocks without edges."""
    from repro_torch.kernels.seg_matmul import (counters, reset_counters,
                                                seg_matmul, seg_matmul_plain)
    rng = np.random.default_rng(3)
    n = 700
    dst = rng.integers(0, 300, 6000)
    dst[dst > 250] += 300  # rows 251-550 receive nothing
    for bs, tile_e in ((32, 64), (128, 256)):
        seg = pops.build_tiled_segments(dst, n, bs=bs, tile_e=tile_e)
        for f in (1, 8, 40):
            msgs = torch.tensor(rng.standard_normal((dst.size, f))).to(
                cuda, TDT[dtype])
            m = pops.pad_messages(msgs, seg).contiguous()
            args = [torch.from_numpy(np.ascontiguousarray(seg[k])).to(cuda)
                    for k in ("blkid", "off", "valid")]
            reset_counters()
            y = seg_matmul(args[0], m, args[1], args[2], seg["n_blocks"],
                           bs=bs, accum_dtype=accum)
            assert counters.seg_matmul == 1
            yp = seg_matmul_plain(args[0], m, args[1], args[2],
                                  seg["n_blocks"], bs=bs, accum_dtype=accum)
            assert y.dtype == msgs.dtype and y.shape == yp.shape
            assert torch.equal(y, yp), (bs, f)
            assert not y[251:550].any()
            ptr = torch.from_numpy(pops.tile_ptr_of(
                seg["blkid"], seg["n_blocks"])).to(cuda)
            assert torch.equal(y, seg_matmul(
                args[0], m, args[1], args[2], seg["n_blocks"], bs=bs,
                accum_dtype=accum, tile_ptr=ptr))


@pytest.mark.cuda
def test_k3_writes_blocks_without_tiles(cuda):
    """A blkid that skips blocks: those rows come out zero (the kernel
    writes every output row once)."""
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_matmul_plain
    blkid = torch.tensor([0, 0, 3], dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(4)
    off = torch.tensor(rng.integers(0, 16, (48, 1)), dtype=torch.int32,
                       device=cuda)
    valid = torch.ones(48, 1, dtype=torch.int32, device=cuda)
    msgs = torch.tensor(rng.standard_normal((48, 5)), device=cuda)
    y = seg_matmul(blkid, msgs, off, valid, 5, bs=16)
    assert torch.equal(y, seg_matmul_plain(blkid, msgs, off, valid, 5,
                                           bs=16))
    assert not y[16:48].any() and not y[64:].any() and y[:16].any()


@pytest.mark.cuda
def test_seg_aggregate_on_the_card_matches_the_cpu(cuda):
    """``seg_aggregate`` on the card equals the same call on the CPU bit
    for bit (both sum each row of a tile in slot order in f64)."""
    from repro_torch.kernels.seg_matmul import counters, reset_counters
    g = generate_webgraph(WebGraphSpec(900, 9000, 0.4, seed=6))
    seg = pops.build_tiled_segments(g.dst, g.n_nodes, bs=128, tile_e=256)
    msgs = torch.tensor(np.random.default_rng(5).standard_normal(
        (g.n_edges, 16)), dtype=torch.float32)
    reset_counters()
    got = pops.seg_aggregate(msgs.to(cuda), seg, bs=128, n_nodes=g.n_nodes)
    assert counters.seg_matmul == 1
    want = pops.seg_aggregate(msgs, seg, bs=128, n_nodes=g.n_nodes)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["bsr", "dense"])
def test_weight_delta_patch_on_the_card(cuda, backend):
    """A weight-only delta on the card: the service patches its plan, every
    served query matches a CPU service given the same deltas (1e-10 L1,
    equal iters and statuses), and a plan of the pre-delta batch patched
    with the post-delta batch (a fresh ``ready`` event, the device
    permutation kept) equals a fresh plan of the post-delta batch."""
    g = generate_webgraph(WebGraphSpec(900, 9000, 0.4, seed=4))
    rng = np.random.default_rng(2)
    qs = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(4)]
    be = make_backend(backend, bsr_block=64, device=cuda)
    out = {}
    for dev in ("cuda", "cpu"):
        svc = RankService(g, RankServiceConfig(device=dev, backend=backend,
                                               v_max=4, bsr_block=64))
        res = svc.rank(qs)
        fs = svc.extractor.extract_union([svc.extractor.extract(q)
                                          for q in qs])
        job = PipelineJob(queries=[svc.validate_roots(q) for q in qs],
                          refresh=True)
        if dev == "cuda":
            plan_pre = be.plan(svc.pipeline.assemble(job).batch)
        pick = np.random.default_rng(5).choice(fs.graph.n_edges, 20,
                                               replace=False)
        svc.apply_edge_delta(reweights=[
            (int(fs.nodes[fs.graph.src[i]]), int(fs.nodes[fs.graph.dst[i]]),
             2.0) for i in pick])
        if dev == "cuda":
            post = svc.pipeline.assemble(job).batch
        res += svc.rank(qs)
        snap = svc.telemetry_snapshot()
        assert snap["service.delta.patched"][backend] >= 1
        out[dev] = res
    for r, o in zip(out["cuda"], out["cpu"]):
        assert r.status == o.status and r.iters == o.iters
        assert np.abs(r.authority - o.authority).sum() <= 1e-10
        assert np.abs(r.hub - o.hub).sum() <= 1e-10
    patched = be.patch(plan_pre, post)
    fresh = be.plan(post)
    torch.cuda.synchronize()
    assert len(patched.ready) == 1 and patched.ready[0].query()
    if backend == "bsr":
        assert patched.perm_dev is plan_pre.perm_dev
        for a, b, old in ((patched.lt, fresh.lt, plan_pre.lt),
                          (patched.lfwd, fresh.lfwd, plan_pre.lfwd)):
            assert a.idx is old.idx and torch.equal(a.idx, b.idx)
            assert torch.equal(a.blocks, b.blocks)
            assert not torch.equal(a.blocks, old.blocks)
    else:
        for a, b, old in ((patched.edges.by_dst, fresh.edges.by_dst,
                           plan_pre.edges.by_dst),
                          (patched.edges.by_src, fresh.edges.by_src,
                           plan_pre.edges.by_src)):
            assert torch.equal(a.gather, b.gather) and torch.equal(a.w, b.w)
            assert not torch.equal(a.w, old.w)


@pytest.mark.cuda
def test_k3_rejects_what_it_does_not_take(cuda):
    from repro_torch.kernels.seg_matmul import seg_matmul
    blkid = torch.zeros(2, dtype=torch.int32, device=cuda)
    off = torch.zeros(16, 1, dtype=torch.int32, device=cuda)
    msgs = torch.ones(16, 3, dtype=torch.float64, device=cuda)
    for bad in (dict(blkid=blkid.long()), dict(off=off.long()),
                dict(msgs=msgs.half()), dict(msgs=msgs[:, ::2]),
                dict(msgs=msgs[:15]), dict(off=off.cpu()),
                dict(tile_ptr=torch.zeros(2, dtype=torch.int32)),
                dict(tile_ptr=torch.zeros(2, device=cuda)),
                dict(tile_ptr=torch.zeros(4, dtype=torch.int32,
                                          device=cuda))):
        args = dict(blkid=blkid, msgs=msgs, off=off, valid=off + 1,
                    tile_ptr=None)
        args.update(bad)
        with pytest.raises(ValueError):
            seg_matmul(args["blkid"], args["msgs"], args["off"],
                       args["valid"], 1, bs=8, tile_ptr=args["tile_ptr"])


# ------------------------------------------- the parallel-then-fold schedules


def k3_layout(name, rng):
    """(dst, n_nodes, bs, tile_e) of one K3 layout. heavy: block 1 owns 45
    tiles, its last one part padding; one_row: three tiles whose 256 slots
    all hit row 5; distinct: tiles of 128 slots that each hit all 128 rows
    once; straddle: row 7's slots 250-261 cross the first tile boundary."""
    if name == "heavy":
        dst = np.concatenate([rng.integers(0, 128, 100),
                              128 + rng.integers(0, 128, 45 * 256 - 7),
                              256 + rng.integers(0, 128, 300)])
        return dst, 3 * 128, 128, 256
    if name == "one_row":
        dst = np.concatenate([np.full(3 * 256, 5), 128 + rng.integers(
            0, 128, 400)])
        return dst, 2 * 128, 128, 256
    if name == "distinct":
        dst = np.concatenate([b * 128 + rng.permutation(128)
                              for b in (0, 0, 1, 2, 2)])
        return dst, 3 * 128, 128, 128
    dst = np.concatenate([rng.integers(0, 128, 250), np.full(12, 7),
                          rng.integers(0, 128, 400)])
    return dst, 128, 128, 256


def k3_messages(rng, e, f):
    """Mixed magnitudes (1e-8 to 1e8) with a tenth of the values -0.0."""
    m = rng.standard_normal((e, f)) * 10.0 ** rng.integers(-8, 9, (e, f))
    m[rng.random((e, f)) < 0.1] = -0.0
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 33, 64])
@pytest.mark.parametrize("layout", ["heavy", "one_row", "distinct",
                                    "straddle"])
def test_k3_schedule_layouts_bit_equal(cuda, layout, f):
    """K3's tiles run in parallel and the last CTA of each block folds
    them in tile order: bit-equal to the plain version in every dtype,
    the same bits on a second run, and the fold counters back at 0."""
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_matmul_plain
    rng = np.random.default_rng(f)
    dst, n, bs, tile_e = k3_layout(layout, rng)
    seg = pops.build_tiled_segments(dst, n, bs=bs, tile_e=tile_e)
    ds = pops.DeviceSegments.of(seg, cuda)
    host = k3_messages(rng, dst.size, f)
    for dtype in ("float64", "float32", "bfloat16"):
        m = pops.pad_messages(torch.tensor(host).to(cuda, TDT[dtype]),
                              seg).contiguous()
        args = (ds.blkid, m, ds.off, ds.valid, ds.n_blocks)
        scr = K.Scratch(cuda)
        y = seg_matmul(*args, bs=bs, tile_ptr=ds.tile_ptr, scratch=scr)
        y2 = seg_matmul(*args, bs=bs, tile_ptr=ds.tile_ptr, scratch=scr)
        yp = seg_matmul_plain(*args, bs=bs)
        assert torch.equal(y, yp), dtype
        assert torch.equal(y, y2), dtype
        assert not scr.cnt.any()


@pytest.mark.cuda
def test_k3_scratch_reused_across_calls(cuda):
    """One Scratch serves two layouts and widths one after the other: both
    results bit-equal to the plain version, the workspace not reallocated
    for the smaller call, the counters at 0 after each."""
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_matmul_plain
    rng = np.random.default_rng(9)
    scr = K.Scratch(cuda)
    ptrs = []
    for layout, f in (("heavy", 64), ("straddle", 33)):
        dst, n, bs, tile_e = k3_layout(layout, rng)
        seg = pops.build_tiled_segments(dst, n, bs=bs, tile_e=tile_e)
        ds = pops.DeviceSegments.of(seg, cuda)
        m = pops.pad_messages(torch.tensor(k3_messages(rng, dst.size, f),
                                           device=cuda).float(), seg)
        args = (ds.blkid, m.contiguous(), ds.off, ds.valid, ds.n_blocks)
        y = seg_matmul(*args, bs=bs, tile_ptr=ds.tile_ptr, scratch=scr)
        assert torch.equal(y, seg_matmul_plain(*args, bs=bs)), layout
        assert not scr.cnt.any()
        ptrs.append(scr.ws.data_ptr())
    assert ptrs[0] == ptrs[1]


def k1_dense_row_operator(bs, dtype, device, rng):
    """8 block rows of bs: row 2 holds every block column, rows 5 and 7
    hold none, the others one block each."""
    idx = [(r, (3 * r) % 8) for r in (0, 1)] + [(2, c) for c in range(8)] \
        + [(r, (3 * r) % 8) for r in (3, 4, 6)]
    idx = np.array(idx, np.int32)
    blocks = rng.standard_normal((len(idx), bs, bs)) * (rng.random(
        (len(idx), bs, bs)) < 0.3)
    row_ptr = pops.row_ptr_of(idx, 8)
    return (torch.tensor(blocks).to(device, TDT[dtype]),
            torch.from_numpy(idx).to(device),
            torch.from_numpy(row_ptr).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
def test_k1_dense_block_row(cuda, dtype):
    """A dense block row beside rows of one block and rows of none, V 1, 3,
    8, 16 and 17 (two column groups): within K1's tolerance of the plain
    version, the same bits on a second run, counters back at 0."""
    rng = np.random.default_rng(21)
    bs = 64
    op = k1_dense_row_operator(bs, dtype, cuda, rng)
    tol = {"float64": 1e-13, "float32": 2.0 ** -20, "bfloat16": 2.0 ** -6}
    for v in (1, 3, 8, 16, 17):
        x = torch.tensor(rng.random((8 * bs, v))).to(cuda, TDT[dtype])
        c = torch.tensor(rng.random((8 * bs, v))).to(cuda, TDT[dtype])
        mk = torch.tensor(rng.random((8 * bs, v)) > 0.2).to(cuda, TDT[dtype])
        scr = K.Scratch(cuda)
        y = K.bsr_scaled_matvec(*op, x, c, bs=bs, mask=mk, scratch=scr)
        y2 = K.bsr_scaled_matvec(*op, x, c, bs=bs, mask=mk, scratch=scr)
        yp = K.bsr_scaled_matvec_plain(*op, x, c, bs=bs, mask=mk)
        err = (y.double() - yp.double()).abs().max().item()
        assert err <= tol[dtype] * yp.double().abs().max().item(), (v, err)
        assert torch.equal(y, y2), v
        assert not scr.cnt.any()
        assert not y[5 * bs:6 * bs].any() and not y[7 * bs:].any()


@pytest.mark.cuda
def test_k1_inactive_flag_leaves_y_and_counters(cuda):
    """With the device flag at 0 every CTA returns at once: y keeps what it
    held and the fold counters stay 0; with the flag at 1 it computes."""
    rng = np.random.default_rng(22)
    op = K.BsrOperand(*k1_dense_row_operator(32, "float64", cuda, rng))
    x = torch.tensor(rng.random((256, 8)), device=cuda)
    c = torch.tensor(rng.random((256, 1)), device=cuda)
    scr = K.Scratch(cuda)
    out = torch.full_like(x, 7.0)
    K._launch_spmm(op, x, c, 32, None, None, out,
                   active=torch.zeros(1, dtype=torch.int32, device=cuda),
                   scratch=scr)
    assert (out == 7.0).all() and not scr.cnt.any()
    K._launch_spmm(op, x, c, 32, None, None, out,
                   active=torch.ones(1, dtype=torch.int32, device=cuda),
                   scratch=scr)
    want = K.bsr_scaled_matvec_plain(*op, x, c, bs=32)
    assert (out - want).abs().max().item() <= 1e-13 * want.abs().max().item()
    assert not scr.cnt.any()


@pytest.mark.cuda
def test_k2_long_run_reuses_one_scratch(cuda, monkeypatch):
    """24 sweeps (an unreachable tolerance) of the K2 graph: one Scratch
    made for the whole call, conv equal and h, a within 1e-10 L1 of the
    plain loop, the same bits on a second run."""
    made = []

    class Counting(K.Scratch):
        def __init__(self, device):
            made.append(device)
            super().__init__(device)

    monkeypatch.setattr(K, "Scratch", Counting)
    g, vecs = loop_inputs(8, 300, 5)
    args = [torch.tensor(x, device=cuda).contiguous() for x in vecs]
    ops = [pops.DeviceBSR.build(g, 32, transpose=t, dtype="float64",
                                device=cuda).operand for t in (True, False)]
    kw = dict(bs=32, max_iter=24)
    got = K.bsr_converge_cols(*ops, *args, 1e-300, **kw)
    assert len(made) == 1
    again = K.bsr_converge_cols(*ops, *args, 1e-300, **kw)
    want = K.bsr_converge_cols_plain(*ops, *args, 1e-300, **kw)
    assert (got[2] == 24).all() and torch.equal(got[2], want[2])
    assert (got[0] - want[0]).abs().sum(0).max().item() <= 1e-10
    assert (got[1] - want[1]).abs().sum(0).max().item() <= 1e-10
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["bsr", "dense"])
def test_queue_on_the_card_matches_the_cpu(cuda, backend):
    """The queued frontend on the card (the prepare thread plans and
    copies, the dispatcher thread sweeps): every served query within
    1e-10 L1 of a cold CPU ranking of its root set (the batches form by
    arrival timing, so statuses and iters are not compared), and the
    card's K2 graph launched once per swept batch."""
    g = generate_webgraph(WebGraphSpec(400, 4000, 0.5, seed=2))
    rng = np.random.default_rng(1)
    vocab = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(10)]
    stream = [vocab[i] for i in rng.integers(0, 10, 40)]
    kw = dict(backend=backend, v_max=4, bsr_block=64)
    svc = RankService(g, RankServiceConfig(device="cuda", **kw))
    K.reset_counters()
    q = svc.queue(deadline_ms=2)
    try:
        tickets = [q.submit(x, priority=i % 2) for i, x in enumerate(stream)]
        got = [t.result(timeout=120) for t in tickets]
    finally:
        q.close(wait=False)
        q._thread.join(timeout=120)
        q.flush()
    assert not q._thread.is_alive()
    cpu = RankService(g, RankServiceConfig(device="cpu",
                                           warm_min_overlap=2.0, **kw))
    for r, x in zip(got, stream):
        if r.status == "shed":
            continue
        o = cpu.rank([x])[0]
        assert np.array_equal(r.nodes, o.nodes)
        assert np.abs(r.authority - o.authority).sum() <= 1e-10
        assert np.abs(r.hub - o.hub).sum() <= 1e-10
    assert q.snapshot_stats()["classes"][0]["shed"] == 0
    if backend == "bsr":
        assert K.counters.bsr_converge == svc.pipeline.stats["swept"] >= 1


@pytest.mark.cuda
def test_restored_plan_on_the_card(cuda, tmp_path):
    """A card service spills its bsr plans; a restarted card service with
    the vectors cleared sweeps through the restored plans (no plan built)
    to the first service's bits; a spill dir the CPU service wrote
    restores on the card within 1e-10 L1, iters equal."""
    g = generate_webgraph(WebGraphSpec(400, 4000, 0.5, seed=2))
    rng = np.random.default_rng(0)
    qs = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(8)]
    kw = dict(backend="bsr", v_max=4, bsr_block=64)
    a = RankService(g, RankServiceConfig(device="cuda",
                                         spill_dir=str(tmp_path / "card"),
                                         **kw))
    first = a.rank(qs)
    assert a.stats["plan_spilled"] == a.stats["plan_misses"] == 2
    b = RankService(g, RankServiceConfig(device="cuda",
                                         spill_dir=str(tmp_path / "card"),
                                         **kw))
    assert b.stats["spill_restored"] == len(qs)
    b.clear_result_cache()
    again = b.rank(qs)
    assert b.stats["plan_restored"] == 2 and b.stats["plan_misses"] == 0
    for x, y in zip(again, first):
        assert x.status == y.status and x.iters == y.iters
        assert np.array_equal(x.authority, y.authority)
        assert np.array_equal(x.hub, y.hub)
    host = RankService(g, RankServiceConfig(device="cpu",
                                            spill_dir=str(tmp_path / "cpu"),
                                            **kw))
    want = host.rank(qs)
    c = RankService(g, RankServiceConfig(device="cuda",
                                         spill_dir=str(tmp_path / "cpu"),
                                         **kw))
    c.clear_result_cache()
    got = c.rank(qs)
    assert c.stats["plan_restored"] == 2 and c.stats["plan_misses"] == 0
    for x, y in zip(got, want):
        assert x.iters == y.iters
        assert np.abs(x.authority - y.authority).sum() <= 1e-10
        assert np.abs(x.hub - y.hub).sum() <= 1e-10


# ------------------------------------------- the offline ranking path


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 4])
@pytest.mark.parametrize("mode", ["replicated", "dual_blocked"])
def test_sharded_service_on_the_card_matches_the_cpu(cuda, mode, s):
    """The sharded backend on the card (S shards placed round-robin over
    the visible cards: logical shards where there is one) serves what the
    same service serves on the CPU: cold, hit and warm batches, then after
    a weight-only delta that patches its plan; within 1e-10 L1 with equal
    iters and statuses. Its plans carry one ready event per card."""
    g = generate_webgraph(WebGraphSpec(900, 9000, 0.4, seed=4))
    rng = np.random.default_rng(2)
    qs = [rng.choice(g.n_nodes, size=5, replace=False) for _ in range(4)]
    out = {}
    for dev in ("cuda", "cpu"):
        svc = RankService(g, RankServiceConfig(
            device=dev, backend="sharded", shard_mode=mode, shard_devices=s,
            v_max=4))
        res = svc.rank(qs) + svc.rank(qs) + svc.rank(qs, refresh=True)
        fs = svc.extractor.extract(qs[0])
        svc.apply_edge_delta(reweights=[(int(fs.nodes[fs.graph.src[0]]),
                                         int(fs.nodes[fs.graph.dst[0]]),
                                         2.0)])
        res += svc.rank(qs, refresh=True)  # the same union, new weights
        snap = svc.telemetry_snapshot()
        assert snap["service.delta.patched"]["sharded"] >= 1
        assert snap["service.delta.replanned"] == 0
        if dev == "cuda":
            mesh = svc._backends["sharded"].mesh
            assert mesh.size == s and all(d.type == "cuda"
                                          for d in mesh.devices)
            torch.cuda.synchronize()
            for plan in svc._plans._plans.values():
                assert len(plan.ready) == len(mesh.distinct_devices())
                assert all(e.query() for e in plan.ready)
        out[dev] = res
    for r, o in zip(out["cuda"], out["cpu"]):
        assert r.status == o.status and r.iters == o.iters
        assert np.abs(r.authority - o.authority).sum() <= 1e-10
        assert np.abs(r.hub - o.hub).sum() <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["replicated", "dual_blocked",
                                  "dual_blocked_compact"])
def test_dist_whole_graph_sweep_on_the_card(cuda, mode):
    """``make_dist_hits_sweep`` on a (4, 2) mesh of the visible cards
    (logical shards where there is one): 60 f64 sweeps within 1e-12 of
    ``accel_hits`` on the card and of the same sweep on the host."""
    from repro_torch.core import accel_hits
    from repro_torch.sparse import dist
    g = generate_webgraph(WebGraphSpec(2000, 16000, 0.5, seed=3))
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    ref = accel_hits(g, tol=1e-12, device="cuda").v
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = dist.make_mesh((4, 2), ("data", "model"), device=dev)
        shards = dist.build_edge_shards(g, 8, mode)
        sweep, h, args = dist.make_dist_hits_sweep(
            mesh, shards, g.n_nodes, ca=ca, ch=ch, dtype="float64")
        for _ in range(60):
            h, _a = sweep(h, *args)
        if mode == "replicated":
            out[dev] = h[0].cpu().numpy()
        else:
            n_keep = shards.get("n_hub", g.n_nodes)
            hf = dist.blocked_to_full(h, n_keep)
            if mode == "dual_blocked_compact":
                out[dev] = np.zeros(g.n_nodes)
                out[dev][shards["nd_ids"]] = hf
            else:
                out[dev] = hf
    assert np.abs(out["cuda"] - ref).max() < 1e-12
    assert np.abs(out["cuda"] - out["cpu"]).max() < 1e-12


@pytest.mark.cuda
def test_k1_whole_graph_v1_bit_equal(cuda):
    """K1 at ``hits_sweep_bsr``'s shape: britannica's unpermuted Lᵀ at
    scale 1.0 (27,214 blocks of 128, 165 per block row), f32, V 1, a
    shared (n_pad, 1) diagonal: bit for bit the plain version (the block
    products of 0/1 blocks and f32 values are exact in f64, and the fold
    adds in idx order), twice, with the fold counters back at 0."""
    from repro_torch.graph import paper_dataset
    g = paper_dataset("britannica", 1.0)
    lt = pops.DeviceBSR.build(g, 128, transpose=True, dtype="float32",
                              device=cuda)
    assert lt.blocks.shape[0] == pops.bsr_nblocks(g, 128, transpose=True)
    assert lt.blocks.shape[0] > 27000
    _, ch = accel_weights(g.indeg(), g.outdeg())
    rng = np.random.default_rng(7)
    cin = pops._rows(torch.tensor(ch, dtype=torch.float32, device=cuda)
                     [:, None], lt.n_pad).contiguous()
    scr = K.Scratch(cuda)
    for x in (torch.full((lt.n_pad, 1), 1.0 / g.n_nodes,
                         dtype=torch.float32, device=cuda),
              torch.tensor(rng.random((lt.n_pad, 1)), dtype=torch.float32,
                           device=cuda)):
        y = K.bsr_scaled_matvec(lt.blocks, lt.idx, lt.row_ptr, x, cin,
                                bs=128, scratch=scr)
        y2 = K.bsr_scaled_matvec(lt.blocks, lt.idx, lt.row_ptr, x, cin,
                                 bs=128, scratch=scr)
        yp = K.bsr_scaled_matvec_plain(lt.blocks, lt.idx, lt.row_ptr, x,
                                       cin, bs=128)
        assert torch.equal(y, yp) and torch.equal(y, y2)
        assert not scr.cnt.any()
    del lt, scr
    gc.collect()
    torch.cuda.empty_cache()


def links_on_cpu(op):
    return K.LinkOperand(op.ptr.cpu(), op.cols.cpu(), op.long_rows.cpu(),
                         op.lanes)


@pytest.mark.cuda
def test_k1_link_form_whole_crawl(cuda):
    """K1's link form at a whole crawl's shape: britannica at scale 1.0
    under the back-button model, f64, V 1, both operators of
    ``hits_sweep_bsr``: bit for bit the plain version (which sums in the
    kernel's order), twice. One sweep launches it twice
    (``k1_links`` 2, ``bsr_spmm`` 0) and counts each operator's ptr, cols
    and long-row list once in ``bsr_spmm_bytes``: 2 x (links + n + 1) x 4
    B plus 4 B a long row."""
    from repro_torch.core import back_button
    from repro_torch.graph import paper_dataset
    g = back_button(paper_dataset("britannica", 1.0))
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    sweep, lt, lf = pops.hits_sweep_bsr(g, ca, ch, dtype="float64",
                                        device=cuda)
    assert lt.long_rows.numel() > 0
    assert lt.lanes == pops.link_lanes(np.bincount(g.dst, minlength=g.n_nodes))
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.random((g.n_nodes, 1)), dtype=torch.float64,
                     device=cuda)
    for op, c in ((lt, ch), (lf, ca)):
        cin = torch.tensor(c, dtype=torch.float64, device=cuda)[:, None] \
            .contiguous()
        y = K.links_scaled_matvec(op, x, cin)
        y2 = K.links_scaled_matvec(op, x, cin)
        yp = K.links_scaled_matvec_plain(links_on_cpu(op), x.cpu(),
                                         cin.cpu())
        assert torch.equal(y, y2) and torch.equal(y.cpu(), yp)
    K.reset_counters()
    sweep(torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64,
                     device=cuda))
    torch.cuda.synchronize()
    c = K.counters
    assert c.k1_links == 2 and c.bsr_spmm == 0
    assert c.bsr_spmm_bytes == 2 * (g.n_edges + g.n_nodes + 1) * 4 \
        + 4 * (lt.long_rows.numel() + lf.long_rows.numel())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("v,per_column", [(1, False), (3, False), (3, True)])
def test_k1_link_form_matches_plain(cuda, dtype, v, per_column):
    """K1's link form on a crawl with empty rows, a hub (a long row, a CTA
    of its own) and a repeated link, for each dtype, V 1 and 3, a shared
    or a per-column diagonal: bit for bit the plain version, twice."""
    rng = np.random.default_rng(13)
    n, e = 5000, 40000
    src, dst = rng.integers(0, n // 2, e), rng.integers(0, n, e)
    dst[: e // 4] = 17
    g = Graph(n, np.append(src, src[:2]), np.append(dst, dst[:2]))
    dt = TDT[dtype]
    x = torch.tensor(rng.random((n, v)), dtype=dt, device=cuda)
    cin = torch.tensor(rng.random((n, v if per_column else 1)), dtype=dt,
                       device=cuda)
    for transpose in (True, False):
        op = pops.link_operand(g, transpose=transpose, device=cuda)
        if transpose:
            assert 17 in op.long_rows.tolist()
        y = K.links_scaled_matvec(op, x, cin)
        y2 = K.links_scaled_matvec(op, x, cin)
        yp = K.links_scaled_matvec_plain(links_on_cpu(op), x.cpu(),
                                         cin.cpu())
        assert y.dtype == dt
        assert torch.equal(y, y2) and torch.equal(y.cpu(), yp)


@pytest.mark.cuda
@pytest.mark.parametrize("check_every", [1, 3])
def test_power_method_jit_graph_matches_host_loop(cuda, check_every):
    """``power_method_jit``'s CUDA graph (a WHILE node over the captured
    K1 sweep of ``hits_sweep_bsr``, f64) against ``power_method`` on the
    same sweep: at check_every 1 equal iters and 1e-10 L1 on v and aux;
    at 3 (the graph's residual spans 3 sweeps, the host loop's one) a
    multiple of 3 no smaller than the host loop's, v within 1e-9 as in
    ``tests/test_system.py``; delta <= tol; max_iter 0 runs nothing."""
    from repro_torch.core.power import power_method, power_method_jit
    from repro_torch.graph import paper_dataset
    g = paper_dataset("jobs", 0.2)
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    sweep, _, _ = pops.hits_sweep_bsr(g, ca, ch, dtype="float64",
                                      device=cuda)
    h0 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64,
                    device=cuda)
    host = power_method(sweep, h0, tol=1e-10, check_every=check_every)
    v, aux, iters, delta = power_method_jit(sweep, h0, tol=1e-10,
                                            check_every=check_every)
    assert v.is_cuda and float(delta) <= 1e-10
    if check_every == 1:
        assert int(iters) == host.iters
        assert np.abs(v.cpu().numpy() - host.v).sum() <= 1e-10
        assert np.abs(aux.cpu().numpy() - host.aux).sum() <= 1e-10
    else:
        assert int(iters) % 3 == 0 and int(iters) >= host.iters
        np.testing.assert_allclose(v.cpu().numpy(), host.v, atol=1e-9)
    v0, aux0, it0, d0 = power_method_jit(sweep, h0, max_iter=0)
    assert int(it0) == 0 and torch.equal(v0, h0) and not aux0.any()
    assert float(d0) == float("inf")


@pytest.mark.cuda
@pytest.mark.parametrize("stragglers", [False, True])
def test_engine_on_card_matches_cpu(cuda, stragglers):
    """``RankingEngine`` on the card against the same engine on the CPU:
    equal iters and stale events, 1e-10 L1 on hub and authority."""
    from repro_torch.core.engine import RankingEngine
    from repro_torch.graph import paper_dataset
    g = paper_dataset("jobs", 0.2)
    kw = dict(n_shards=8)
    if stragglers:
        kw.update(straggler_prob=0.3, stale_limit=2, seed=3)
    got = RankingEngine(g, "accel", device=cuda, **kw).run(tol=1e-10)
    ref = RankingEngine(g, "accel", device="cpu", **kw).run(tol=1e-10)
    assert got.converged and got.iters == ref.iters
    assert got.stale_events == ref.stale_events
    assert (got.stale_events > 0) == stragglers
    assert np.abs(got.hub - ref.hub).sum() <= 1e-10
    assert np.abs(got.authority - ref.authority).sum() <= 1e-10


@pytest.mark.cuda
def test_hits_sweep_bsr_raises_past_free_memory(cuda, monkeypatch):
    """Operators larger than the card's free memory raise before any is
    built; nothing switches path. The free memory reported is 4 B a link,
    below the link form's 8 B a link (both operators' cols) and ptr."""
    from repro_torch.graph import paper_dataset
    g = paper_dataset("jobs", 0.05)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (4 * g.n_edges, 80 << 30))
    with pytest.raises(MemoryError, match="hits_sweep_bsr"):
        pops.hits_sweep_bsr(g, device=cuda)


# ------------------------------------------------- the recsys family
RECSYS_ARCHS = ("dlrm-rm2", "dcn-v2", "bst", "two-tower-retrieval")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECSYS_ARCHS)
def test_recsys_card_matches_host(arch, cuda):
    """Smoke config, the host module's parameters carried to the card:
    loss and every gradient within 1e-4 of the host's (relative to the
    largest magnitude; TF32 off), and two identical card train steps give
    the same bits (F.embedding's backward has no float atomics)."""
    from repro_torch.configs import get_spec
    from repro_torch.launch.train import model_and_data
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, to_device,
                                   value_and_grad)
    from repro_torch.tree import leaves
    assert torch.get_float32_matmul_precision() == "highest"
    cfg = get_spec(arch).smoke_config
    host, fn, batch_fn = model_and_data(cfg, 64, 0, "cpu")
    card = [model_and_data(cfg, 64, 1, cuda)[0].params_from_reference(
        host.to_tree()) for _ in range(2)]
    batch = batch_fn(0)
    lc, gc = value_and_grad(fn, host, batch)
    ld, gd = value_and_grad(fn, card[0], to_device(batch, cuda))
    for a, b in [(ld, lc)] + list(zip(leaves(gd), leaves(gc))):
        a, b = a.double().cpu(), b.double()
        assert float((a - b).abs().max()) <= 1e-4 * max(
            float(b.abs().max()), 1e-30)
    step = make_train_step(fn, AdamWConfig(lr=1e-3, warmup_steps=1))
    states = [init_opt_state(m) for m in card]
    for m, st in zip(card, states):
        step(m, st, to_device(batch, cuda))
    for x, y in zip(leaves(card[0].to_tree()) + leaves(states[0]["m"]),
                    leaves(card[1].to_tree()) + leaves(states[1]["m"])):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_chunked_attention_and_topk_on_card(cuda):
    """``chunked_attention`` on the card against the host (GQA, causal,
    windowed, a padded last chunk: 1e-5 of the largest magnitude);
    ``topk`` on the card breaks ties to the lowest index."""
    from repro_torch.models.layers import chunked_attention
    from repro_torch.models.recsys import topk
    g = torch.Generator().manual_seed(0)
    q = torch.randn((2, 19, 6, 8), generator=g)
    k, v = (torch.randn((2, 19, 2, 8), generator=g) for _ in range(2))
    for kw in (dict(causal=True, window=5, chunk=8),
               dict(causal=False, chunk=8)):
        want = chunked_attention(q, k, v, **kw)
        got = chunked_attention(q.to(cuda), k.to(cuda), v.to(cuda), **kw)
        assert float((got.cpu() - want).abs().max()) <= 1e-5 * float(
            want.abs().max())
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0, 2.0, 0.0]] * 3,
                     device=cuda)
    _, idx = topk(s, 5)
    assert idx.cpu().tolist() == [[1, 2, 4, 3, 6]] * 3


@pytest.mark.cuda
def test_train_launcher_on_card(cuda, tmp_path):
    """``python -m repro_torch.launch.train`` on the card (bst smoke):
    CUDA-event timing with a peak memory, a checkpoint, then ``--resume``."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "bst", "--smoke", "--batch", "64", "--ckpt-every", "4",
            "--ckpt", str(tmp_path / "ck")]
    r = subprocess.run(args + ["--steps", "8"], capture_output=True,
                       text=True, env=env, cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "(CUDA events)" in r.stdout and " GB" in r.stdout, r.stdout
    r = subprocess.run(args + ["--steps", "10", "--resume"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed from step 8" in r.stdout and "done: 2 steps" in r.stdout


# ------------------------------------------------------- the LM family
LM_ARCHS = ("deepseek-v2-236b", "mixtral-8x7b", "deepseek-7b",
            "minitron-4b", "minitron-8b")


def chip_smoke():
    """``chip_smoke.py`` as a module: phase 3h's checks live there."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
@pytest.mark.parametrize("own", [True, False])
def test_lm_card_matches_host(arch, own, cuda):
    """Phase 3h (a) at smoke size (``chip_smoke.lm_vs_host``), at the
    config's own compute dtype and at f32: forward logits, loss,
    gradients and 30 decode steps against the host CPU, ``kvquant`` of
    the host's cache bit-equal on the card, two identical card decode
    runs and train steps (MoE dispatch and combine included) bit-equal."""
    from repro_torch.configs import get_spec
    cdt = get_spec(arch).smoke_config.compute_dtype if own else "float32"
    line, bad = chip_smoke().lm_vs_host(arch, cdt, cuda)
    assert not bad, line


@pytest.mark.cuda
def test_serve_launcher_on_card(cuda, tmp_path):
    """``python -m repro_torch.launch.serve --smoke`` on the card names
    the card in its throughput line."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--arch", "mixtral-8x7b", "--smoke"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"({torch.cuda.get_device_name(cuda)})" in r.stdout, r.stdout


# ------------------------------------------------------ the GNN family
@pytest.mark.cuda
def test_gnn_card_matches_host(cuda):
    """Phase 3i (a) at smoke size (``chip_smoke.gnn_vs_host``): each mode's
    loss and gradients against the host CPU within 1e-5, K3 launched
    twice a layer, two identical card train steps bit-equal."""
    line, bad = chip_smoke().gnn_vs_host(cuda)
    assert not bad, line


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_gnn_aggregate_on_card_matches_plain(cuda, weighted):
    """Phase 3i (b) at Cora's shape (``chip_smoke.agg_vs_plain``): the
    aggregation's forward and backward through K3, two launches, each
    bit-equal to ``seg_matmul_plain`` on the card (a mismatch exits)."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    src, dst = (torch.randint(0, 2708, (10556,), generator=gen, device=cuda)
                for _ in range(2))
    w = torch.rand(10556, generator=gen, device=cuda) if weighted else None
    r = chip_smoke().agg_vs_plain(cuda, src, dst, 2708, w=w)
    assert r["launches"] == 2 and r["e"] == 10556


@pytest.mark.cuda
def test_gnn_train_launcher_on_card(cuda, tmp_path):
    """``python -m repro_torch.launch.train --arch gin-tu --smoke`` on the
    card: the reference's lines and the CUDA-event timing line."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--arch", "gin-tu", "--smoke", "--steps", "8"],
                       capture_output=True, text=True, env=env,
                       cwd=tmp_path, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "done: 8 steps" in r.stdout and "(CUDA events)" in r.stdout, \
        r.stdout
