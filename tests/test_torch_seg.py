"""The port's segment-sum path (``build_tiled_segments`` → ``pad_messages``
→ K3 ``seg_matmul`` → ``seg_aggregate``) on the CPU, through K3's plain
torch version, against the JAX package's, whose Pallas kernel runs in
interpret mode as its own tests run it.

The bf16 reference results come from one subprocess that runs this file
as a script with ``--xla_allow_excess_precision=false``: XLA on the CPU
otherwise keeps excess precision and skips bf16 roundings the reference's
source writes (and the port performs). ``tests/test_torch_cuda.py`` holds
the CUDA kernel to the same plain version on a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as rk
from repro.graph import Graph as RGraph
from repro.graph import WebGraphSpec, generate_webgraph
from repro.kernels.ref import seg_matmul_ref as r_oracle
from repro.kernels.seg_matmul import seg_matmul as r_seg_matmul
import repro_torch.kernels.ops as pk
from repro_torch.kernels.seg_matmul import (counters, reset_counters,
                                            seg_matmul, seg_matmul_plain)
from repro_torch.kernels.ref import seg_matmul_ref as p_oracle

ROOT = Path(__file__).resolve().parents[1]
# the reference test's grid (tests/test_kernels.py::test_seg_matmul_sweep)
GRID = [(32, 64), (128, 256), (64, 128)]
WIDTHS = [4, 16]


def graph(bs, f):
    return generate_webgraph(WebGraphSpec(400, 3000, 0.4, seed=bs + f))


def empty_block_graph():
    """Destinations only in rows [0, 40) and [200, 230) of 300: blocks of
    32 rows 2-5 and 8-9 receive no edge and get one padding tile each."""
    rng = np.random.default_rng(11)
    dst = np.concatenate([rng.integers(0, 40, 500), rng.integers(200, 230,
                                                                 300)])
    return RGraph(300, rng.integers(0, 300, dst.size), dst)


def messages(g, f, seed=0):
    return np.random.default_rng(seed).standard_normal((g.n_edges, f))


def both_segments(g, bs, tile_e):
    dst = np.asarray(g.dst)
    return (rk.build_tiled_segments(dst, g.n_nodes, bs=bs, tile_e=tile_e),
            pk.build_tiled_segments(dst, g.n_nodes, bs=bs, tile_e=tile_e))


def reference(g, msgs, bs, tile_e, dtype):
    seg, _ = both_segments(g, bs, tile_e)
    return np.asarray(rk.seg_aggregate(jnp.asarray(msgs, dtype), seg, bs=bs,
                                       n_nodes=g.n_nodes, interpret=True))


def port(g, msgs, bs, tile_e, dtype):
    _, seg = both_segments(g, bs, tile_e)
    return pk.seg_aggregate(torch.from_numpy(msgs).to(dtype), seg, bs=bs,
                            n_nodes=g.n_nodes)


@pytest.mark.parametrize("bs,tile_e", GRID + [(32, 16)])
def test_segments_and_padded_messages_equal(bs, tile_e):
    """``build_tiled_segments`` returns the reference's arrays bit for bit
    (including empty blocks' padding tiles), and ``pad_messages`` lays
    out the same values."""
    for g in (graph(bs, 4), empty_block_graph()):
        r, p = both_segments(g, bs, tile_e)
        assert set(r) == set(p)
        for k in r:
            assert np.array_equal(np.asarray(r[k]), np.asarray(p[k])), k
            assert np.asarray(r[k]).dtype == np.asarray(p[k]).dtype, k
        msgs = messages(g, 3).astype(np.float32)
        got = pk.pad_messages(torch.from_numpy(msgs), p).numpy()
        assert np.array_equal(got, np.asarray(rk.pad_messages(
            jnp.asarray(msgs), r)))


@pytest.mark.parametrize("bs,tile_e", GRID)
@pytest.mark.parametrize("f", WIDTHS)
def test_seg_aggregate_f32_matches_reference(bs, tile_e, f):
    """f32 at the reference test's rtol = atol = 1e-5: both sum a row's
    f32 messages, the reference in XLA's order and the port in f64
    rounded once per tile (the observed gap is ~4e-6 on rows up to ~40)."""
    g = graph(bs, f)
    msgs = messages(g, f, seed=f).astype(np.float32)
    want = reference(g, msgs, bs, tile_e, jnp.float32)
    got = port(g, msgs, bs, tile_e, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bs,tile_e", GRID)
def test_seg_aggregate_f64_keeps_the_f32_accumulator(bs, tile_e):
    """f64 messages of magnitudes 1 and 2^-30 (~1e-9), all positive: the
    reference casts each tile to its f32 accumulator, where 1 + k*2^-30
    rounds to 1 in every summation order, and adds the tiles in f64. The
    port equals it bit for bit; an f64 accumulation keeps the small
    messages and misses by ~1e-7."""
    g = graph(bs, 8)
    rng = np.random.default_rng(bs)
    big = rng.random((g.n_edges, 8)) < 0.5
    msgs = np.where(big, 1.0, 2.0 ** -30 * rng.integers(1, 4, big.shape))
    want = reference(g, msgs, bs, tile_e, jnp.float64)
    got = port(g, msgs, bs, tile_e, torch.float64).numpy()
    assert np.array_equal(got, want)
    exact = np.zeros_like(want)
    np.add.at(exact, np.asarray(g.dst), msgs)
    assert np.abs(exact - want).max() > 1e-8  # the case tells them apart
    _, seg = both_segments(g, bs, tile_e)
    m = pk.pad_messages(torch.from_numpy(msgs), seg)
    f64 = seg_matmul(torch.from_numpy(seg["blkid"]), m,
                     torch.from_numpy(seg["off"]),
                     torch.from_numpy(seg["valid"]), seg["n_blocks"], bs=bs,
                     accum_dtype="float64")[:g.n_nodes]
    assert np.abs(f64.numpy() - want).max() > 1e-8


@pytest.mark.parametrize("bs,tile_e", GRID)
def test_seg_matmul_f64_accumulator_matches_reference(bs, tile_e):
    """``accum_dtype`` float64: both sum f64 messages in f64, in different
    orders: rtol 1e-13."""
    g = graph(bs, 4)
    r, p = both_segments(g, bs, tile_e)
    msgs = messages(g, 4, seed=3)
    mr = rk.pad_messages(jnp.asarray(msgs), r)
    want = np.asarray(r_seg_matmul(jnp.asarray(r["blkid"]), mr,
                                   jnp.asarray(r["off"]),
                                   jnp.asarray(r["valid"]), r["n_blocks"],
                                   bs=bs, interpret=True,
                                   accum_dtype=jnp.float64))
    mp = pk.pad_messages(torch.from_numpy(msgs), p)
    got = seg_matmul(torch.from_numpy(p["blkid"]), mp,
                     torch.from_numpy(p["off"]),
                     torch.from_numpy(p["valid"]), p["n_blocks"], bs=bs,
                     accum_dtype=torch.float64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())


def test_empty_destination_blocks():
    """Blocks without edges come out zero, and the rest match the
    reference (f32, 1e-5) and the scatter-add of the messages."""
    g = empty_block_graph()
    msgs = messages(g, 5, seed=4).astype(np.float32)
    want = reference(g, msgs, 32, 64, jnp.float32)
    got = port(g, msgs, 32, 64, torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = np.zeros((g.n_nodes, 5))
    np.add.at(exact, np.asarray(g.dst), msgs.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    assert not got[40:200].any() and not got[230:].any()


def test_oracle_matches_reference_oracle():
    """``kernels.ref.seg_matmul_ref`` computes the reference oracle's f32
    scatter-add; the plain K3 agrees with it to f32 rounding."""
    g = graph(64, 4)
    r, p = both_segments(g, 64, 128)
    msgs = messages(g, 4, seed=5).astype(np.float32)
    mr = rk.pad_messages(jnp.asarray(msgs), r)
    want = np.asarray(r_oracle(jnp.asarray(r["blkid"]), mr,
                               jnp.asarray(r["off"]),
                               jnp.asarray(r["valid"]), r["n_blocks"], 64))
    args = (torch.from_numpy(p["blkid"]), pk.pad_messages(
        torch.from_numpy(msgs), p), torch.from_numpy(p["off"]),
        torch.from_numpy(p["valid"]), p["n_blocks"])
    got = p_oracle(*args, 64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(seg_matmul_plain(*args, bs=64).numpy(),
                               want, rtol=1e-5, atol=1e-5)


def bf16_messages(g, f):
    return messages(g, f, seed=100 + f)


def compute_oracle(path):
    import jax
    jax.config.update("jax_enable_x64", True)
    out = {}
    for bs, tile_e in GRID:
        for f in WIDTHS:
            g = graph(bs, f)
            out[f"{bs}/{tile_e}/{f}"] = reference(
                g, bf16_messages(g, f), bs, tile_e, jnp.bfloat16).astype(
                    np.float32)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("seg_oracle") / "ref.npz"
    flags = (os.environ.get("XLA_FLAGS", "")
             + " --xla_allow_excess_precision=false").strip()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", XLA_FLAGS=flags)
    out = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


@pytest.mark.parametrize("bs,tile_e", GRID)
@pytest.mark.parametrize("f", WIDTHS)
def test_seg_aggregate_bf16_bit_exact(oracle, bs, tile_e, f):
    """bf16 messages: each tile's f32 sum rounds to bf16 and joins the
    row's bf16 running sum, in both; with XLA's excess precision off the
    reference equals the port bit for bit."""
    g = graph(bs, f)
    got = port(g, bf16_messages(g, f), bs, tile_e, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(), oracle[f"{bs}/{tile_e}/{f}"])


def test_plain_sums_each_row_in_slot_order():
    """The plain version sums a row's slots of one tile in slot order in
    f64 and rounds once: checked against a Python loop on a tile whose
    slots for one row are out of order and of mixed magnitude."""
    tile_e, bs = 8, 4
    off = np.array([2, 0, 2, 3, 2, 0, 1, 2], np.int32)[:, None]
    valid = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.int32)[:, None]
    vals = np.array([1e16, 3.0, 1.0, 7.0, -1e16, 5.0, 2.0, 9.0])[:, None]
    y = seg_matmul_plain(torch.zeros(1, dtype=torch.int32),
                           torch.from_numpy(vals), torch.from_numpy(off),
                           torch.from_numpy(valid), 1, bs=bs,
                           accum_dtype="float64").numpy()[:, 0]
    want = np.zeros(bs)
    for s in range(tile_e):
        if valid[s, 0]:
            want[off[s, 0]] += vals[s, 0]
    assert np.array_equal(y, want)  # row 2: (1e16 + 1) - 1e16 = 0
    assert y[2] == 0.0


def test_accumulator_is_f32_or_f64():
    """The reference's default accumulator is f32; f64 is the other one
    its callers pass. Anything else is refused on either device."""
    g = graph(32, 4)
    _, seg = both_segments(g, 32, 64)
    m = pk.pad_messages(torch.from_numpy(messages(g, 4)), seg)
    args = (torch.from_numpy(seg["blkid"]), m, torch.from_numpy(seg["off"]),
            torch.from_numpy(seg["valid"]), seg["n_blocks"])
    for acc in ("bfloat16", torch.float16):
        with pytest.raises(ValueError):
            seg_matmul(*args, bs=32, accum_dtype=acc)
    with pytest.raises(ValueError, match="tiles"):
        seg_matmul(args[0][:-1], *args[1:], bs=32)


def test_wrapper_counts_nothing_on_the_cpu():
    g = graph(32, 4)
    reset_counters()
    port(g, messages(g, 4).astype(np.float32), 32, 64, torch.float32)
    assert counters.seg_matmul == 0
    assert not any(counters.as_dict().values())


@pytest.mark.parametrize("bs,tile_e", GRID + [(32, 16)])
def test_tile_ptr_points_at_each_blocks_tiles(bs, tile_e):
    """``tile_ptr_of`` (made once on the host for K3) gives each block
    its run of the sorted blkid, at least one tile per block, and rejects
    an unsorted blkid."""
    for g in (graph(bs, 4), empty_block_graph()):
        seg = pk.build_tiled_segments(g.dst, g.n_nodes, bs=bs, tile_e=tile_e)
        blkid, nb = seg["blkid"], seg["n_blocks"]
        ptr = pk.tile_ptr_of(blkid, nb)
        assert ptr.dtype == np.int32 and ptr.shape == (nb + 1,)
        assert np.array_equal(ptr, np.searchsorted(blkid, np.arange(nb + 1)))
        assert (np.diff(ptr) >= 1).all() and ptr[-1] == len(blkid)
        for b in range(nb):
            assert (blkid[ptr[b]:ptr[b + 1]] == b).all()
    with pytest.raises(ValueError, match="sorted"):
        pk.tile_ptr_of(np.array([0, 2, 1], np.int32), 3)


def layout_dst(layout):
    """(dst, n_nodes) of the layouts K3's parallel schedule is tested at
    (bs 32, tile_e 16): heavy, one block of 42 tiles beside two light
    ones; one_row, a block whose first three tiles hit one row only."""
    rng = np.random.default_rng(12)
    if layout == "heavy":
        return np.concatenate([rng.integers(0, 32, 20),
                               32 + rng.integers(0, 32, 42 * 16 - 5),
                               64 + rng.integers(0, 32, 9)]), 96
    return np.concatenate([np.full(3 * 16, 9), rng.integers(0, 32, 7),
                           32 + rng.integers(0, 32, 30)]), 64


@pytest.mark.parametrize("accum", ["float32", "float64"])
@pytest.mark.parametrize("layout", ["heavy", "one_row"])
def test_plain_k3_at_schedule_layouts_matches_reference(layout, accum):
    """The plain K3 (the kernel's bit-equal twin) against the JAX
    ``seg_matmul`` in interpret mode at the layouts the parallel schedule
    is tested at on the card: f32 messages at the reference test's 1e-5,
    f64 messages with the f64 accumulator at rtol 1e-13 (two summation
    orders)."""
    dst, n = layout_dst(layout)
    r = rk.build_tiled_segments(dst, n, bs=32, tile_e=16)
    p = pk.build_tiled_segments(dst, n, bs=32, tile_e=16)
    assert np.diff(pk.tile_ptr_of(p["blkid"], p["n_blocks"])).max() >= (
        42 if layout == "heavy" else 3)
    msgs = np.random.default_rng(2).standard_normal((dst.size, 5))
    jdt, tdt, rtol = ((jnp.float32, torch.float32, 1e-5) if accum ==
                      "float32" else (jnp.float64, torch.float64, 1e-13))
    mr = rk.pad_messages(jnp.asarray(msgs, jdt), r)
    want = np.asarray(r_seg_matmul(jnp.asarray(r["blkid"]), mr,
                                   jnp.asarray(r["off"]),
                                   jnp.asarray(r["valid"]), r["n_blocks"],
                                   bs=32, interpret=True,
                                   accum_dtype=jnp.dtype(accum)))
    mp = pk.pad_messages(torch.from_numpy(msgs).to(tdt), p)
    got = seg_matmul_plain(torch.from_numpy(p["blkid"]), mp,
                           torch.from_numpy(p["off"]),
                           torch.from_numpy(p["valid"]), p["n_blocks"],
                           bs=32, accum_dtype=accum)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_seg_scratch_sizes():
    """K3's workspace holds every tile's (bs, F) contribution in the
    messages' dtype; one fold counter per block and 32-column chunk."""
    from repro_torch.kernels.seg_matmul import SEG_FC, seg_scratch_sizes
    assert SEG_FC == 32
    assert seg_scratch_sizes(2024, 165, 128, 64, 4) == (2024 * 128 * 64 * 4,
                                                        330)
    assert seg_scratch_sizes(10, 4, 32, 1, 8) == (10 * 32 * 8, 4)
    assert seg_scratch_sizes(10, 4, 32, 33, 2)[1] == 8
    assert seg_scratch_sizes(10, 4, 32, 32, 2)[1] == 4


def test_device_segments_cached_per_layout():
    """``DeviceSegments.of`` ships a layout once per device: the same
    object on the second call, a new one for another layout, the entry
    gone with the layout; the seg dict keeps the reference's keys."""
    import gc
    g = graph(32, 4)
    seg = pk.build_tiled_segments(g.dst, g.n_nodes, bs=32, tile_e=64)
    keys = set(seg)
    a = pk.DeviceSegments.of(seg, "cpu")
    assert pk.DeviceSegments.of(seg, "cpu") is a and set(seg) == keys
    assert np.array_equal(a.tile_ptr.numpy(),
                          pk.tile_ptr_of(seg["blkid"], seg["n_blocks"]))
    assert a.blkid.dtype == a.off.dtype == a.valid.dtype == torch.int32
    other = pk.build_tiled_segments(g.dst, g.n_nodes, bs=32, tile_e=64)
    b = pk.DeviceSegments.of(other, "cpu")
    assert b is not a
    n = len(pk._SEG_CACHE)
    del seg, other
    gc.collect()
    assert len(pk._SEG_CACHE) == n - 2


if __name__ == "__main__":
    compute_oracle(sys.argv[1])
