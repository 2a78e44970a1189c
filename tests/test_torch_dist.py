"""The port's ``sparse/dist.py`` (one process over a tuple of devices)
against the JAX package's ``repro.sparse.dist`` under ``shard_map``, on
the CPU: the edge shards, the single-graph sweep in all three modes on a
(4, 2) mesh, the collectives (``psum`` in XLA's order, the chunked ring
all-reduce) and the wire-byte ladder.

The reference's mesh results come from one subprocess that runs this file
as a script with ``--xla_force_host_platform_device_count=8`` and
``--xla_allow_excess_precision=false``; the numpy-only functions are
compared in this process.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.sparse import dist as rdist
from repro_torch.core import accel_hits, accel_weights
from repro_torch.graph import WebGraphSpec, generate_webgraph
from repro_torch.serve import ShardedSweepBackend
from repro_torch.sparse import dist

ROOT = Path(__file__).resolve().parents[1]
MODES = ("replicated", "dual_blocked", "dual_blocked_compact")
COL_MODES = ("replicated", "dual_blocked")
PSUM = [(s, dt) for s in (3, 4, 8) for dt in ("float64", "float32",
                                               "bfloat16")]
WIRE_SHARDS = (2, 3, 4, 8)
N_PAD, V = 256, 4  # the wire-byte probe's shape (tests/test_serve_backends)


def graph():
    return generate_webgraph(WebGraphSpec(200, 1500, 0.6, seed=1))


def psum_parts(s, dtype):
    """Seeded (S, 4000) parts over a wide range of magnitudes (f64, f32),
    or of bf16 values (held as float32)."""
    rng = np.random.default_rng(s)
    spread = 3 if dtype == "bfloat16" else 20
    x = rng.standard_normal((s, 4000)) * np.exp(rng.uniform(-spread, spread,
                                                            (s, 4000)))
    if dtype == "float64":
        return x
    x = x.astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def ring_input():
    return np.random.default_rng(0).standard_normal((8, 53))


def compute_oracle(path):
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from jax.sharding import PartitionSpec as P
    jax.config.update("jax_enable_x64", True)
    assert len(jax.devices()) == 8, jax.devices()
    from repro.compat import make_mesh, set_mesh, shard_map
    from repro.core import accel_hits as ref_accel
    from repro.core import accel_weights as ref_weights
    from repro.graph import WebGraphSpec as RSpec
    from repro.graph import generate_webgraph as rgen
    from repro.serve.backends import ShardedSweepBackend as RefBackend
    out = {}
    g = rgen(RSpec(200, 1500, 0.6, seed=1))
    out["accel"] = np.asarray(ref_accel(g, tol=1e-12, dtype=jnp.float64).v)
    ca, ch = ref_weights(g.indeg(), g.outdeg())
    mesh = make_mesh((4, 2), ("data", "model"))
    for mode in MODES:
        shards = rdist.build_edge_shards(g, 8, mode)
        sweep, h, args = rdist.make_dist_hits_sweep(
            mesh, shards, g.n_nodes, axes=("data", "model"), ca=ca, ch=ch,
            dtype=jnp.float64)
        with set_mesh(mesh):
            sweep_j = jax.jit(sweep)
            for _ in range(60):
                h, _a = sweep_j(h, *args)
        out[f"sweep/{mode}"] = np.asarray(h)

    for s, dt in PSUM:
        m = make_mesh((s,), ("d",), devices=jax.devices()[:s])
        f = shard_map(lambda xs: jax.lax.psum(xs[0], "d")[None], mesh=m,
                      in_specs=P("d", None), out_specs=P("d", None))
        x = psum_parts(s, dt)
        xj = jnp.asarray(x.astype(ml_dtypes.bfloat16) if dt == "bfloat16"
                         else x)
        with set_mesh(m):
            got = np.asarray(jax.jit(f)(xj))
        out[f"psum/{s}/{dt}"] = got.astype(np.float64)

    m8 = make_mesh((8,), ("data",))
    ring = shard_map(
        lambda xs: rdist.ring_allreduce_chunked(xs[0], "data", 3)[None],
        mesh=m8, in_specs=P("data", None), out_specs=P("data", None))
    with set_mesh(m8):
        out["ring"] = np.asarray(jax.jit(ring)(jnp.asarray(ring_input())))

    w = np.ones(g.n_edges)
    for s in WIRE_SHARDS:
        for mode in COL_MODES:
            be = RefBackend(mode=mode, n_devices=s)
            out[f"wire/{mode}/{s}"] = np.array(
                be.measure_wire_bytes(N_PAD, V, g.src, g.dst, w))
    np.savez(path, **out)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    path = tmp_path_factory.mktemp("dist_oracle") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8 "
                         "--xla_allow_excess_precision=false")
    out = subprocess.run([sys.executable, __file__, str(path)], env=env,
                         capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def edges_with_sentinels(n_pad=300, e=2500, seed=3):
    """A padded serving edge list: real edges, a few zero-weight edges
    among them and sentinel edges at the dead pad row."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_pad - 1, e).astype(np.int32)
    dst = rng.integers(0, n_pad - 1, e).astype(np.int32)
    w = rng.uniform(0.5, 2.0, e)
    w[rng.choice(e, 40, replace=False)] = 0.0
    pad = 3000 - e
    return (np.concatenate([src, np.full(pad, n_pad - 1, np.int32)]),
            np.concatenate([dst, np.full(pad, n_pad - 1, np.int32)]),
            np.concatenate([w, np.zeros(pad)]), n_pad)


def flat(d, prefix=""):
    out = {}
    for k, x in d.items():
        if isinstance(x, dict):
            out.update(flat(x, prefix + k + "/"))
        else:
            out[prefix + k] = x
    return out


@pytest.mark.parametrize("s", (1, 2, 3, 4, 8))
@pytest.mark.parametrize("mode", COL_MODES)
def test_build_edge_shards_cols_matches_reference(mode, s):
    """The same (S, per) arrays, per and nb, sentinel edges included (the
    stripped w=0 edges, the dead pad row's gathers and the block-start
    scatters of dual_blocked)."""
    src, dst, w, n_pad = edges_with_sentinels()
    got = flat(dist.build_edge_shards_cols(src, dst, w, n_pad, s, mode))
    want = flat(rdist.build_edge_shards_cols(src, dst, w, n_pad, s, mode))
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k


@pytest.mark.parametrize("mode", COL_MODES)
def test_edge_args_and_layouts(mode):
    """``device_put_edge_args_cols`` keeps the reference's calling order
    with shard s's row on shard s's device; each shard's layouts hold its
    nonzero-weight edges stably sorted by scatter index (edge order within
    a segment; the padding, which adds exact zeros, left out)."""
    src, dst, w, n_pad = edges_with_sentinels()
    mesh = dist.make_mesh(3, device="cpu")
    shards = dist.build_edge_shards_cols(src, dst, w, n_pad, 3, mode)
    eargs = dist.device_put_edge_args_cols(shards, "float64", mesh)
    want = rdist.device_put_edge_args_cols(shards, np.float64)
    assert len(eargs) == len(want)
    for got, ref in zip(eargs, want):
        assert len(got) == 3
        assert np.array_equal(np.stack([x.numpy() for x in got]),
                              np.asarray(ref))
    nb = -(-n_pad // 3)
    for s, (la, lh) in enumerate(dist.edge_layouts_cols(mesh, mode, eargs,
                                                        n_pad)):
        e = [x[s].numpy() for x in eargs]
        parts = ((e[0], e[1], e[2]), (e[1], e[0], e[2])) \
            if mode == "replicated" else ((e[0], e[1], e[2]),
                                          (e[3], e[4], e[5]))
        base = 0 if mode == "replicated" else s * nb
        for lay, (gat, sc, ww) in zip((la, lh), parts):
            live = ww != 0
            gat, sc, ww = gat[live], sc[live], ww[live]
            order = np.argsort(sc, kind="stable")
            assert np.array_equal(lay.gather.numpy(), gat[order])
            assert np.array_equal(lay.w.numpy(), ww[order])
            assert np.array_equal(lay.lengths.numpy(), np.bincount(
                sc - base, minlength=len(lay.lengths)))


def test_collective_bytes_per_sweep_cols_matches_reference():
    for mode in COL_MODES:
        for s in (1, 2, 3, 4, 8):
            for n_pad, v, item in ((256, 4, 8), (4096, 8, 8), (300, 3, 2)):
                assert dist.collective_bytes_per_sweep_cols(
                    mode, n_pad, v, s, item) == \
                    rdist.collective_bytes_per_sweep_cols(mode, n_pad, v, s,
                                                          item)
    by_kind = {"all-reduce": 4096, "all-gather": 1000,
               "collective-permute": 77}
    for s in (1, 3, 8):
        assert dist.wire_bytes_from_collectives(by_kind, s) == \
            rdist.wire_bytes_from_collectives(by_kind, s)
    with pytest.raises(ValueError):
        dist.collective_bytes_per_sweep_cols("nope", 8, 1, 2)


@pytest.mark.parametrize("mode", MODES)
def test_dist_hits_sweep_matches_reference(oracle, mode):
    """60 f64 sweeps on a (4, 2) mesh (8 shards, the flat index row-major
    over both axes): within 1e-12 max abs of the reference's vector and
    of ``accel_hits``, the port's and the reference's."""
    g = graph()
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    mesh = dist.make_mesh((4, 2), ("data", "model"), device="cpu")
    assert mesh.size == 8 and mesh.shape == (4, 2)
    shards = dist.build_edge_shards(g, 8, mode)
    sweep, h, args = dist.make_dist_hits_sweep(
        mesh, shards, g.n_nodes, ca=ca, ch=ch, dtype="float64")
    mesh.reset_counters()
    for _ in range(60):
        h, _a = sweep(h, *args)
    assert mesh.segment_sums == 60 * 2 * 8
    if mode == "replicated":
        assert all(torch.equal(x, h[0]) for x in h)
        hf = h[0].numpy()
        assert set(mesh.collective_bytes) == {"all-reduce"}
    else:
        assert set(mesh.collective_bytes) == {"all-gather", "all-reduce"}
        hf = dist.blocked_to_full(h, g.n_nodes)
        if mode == "dual_blocked_compact":
            compact = dist.blocked_to_full(h, shards["n_hub"])
            hf = np.zeros(g.n_nodes)
            hf[shards["nd_ids"]] = compact
    want = oracle[f"sweep/{mode}"]
    if mode == "dual_blocked":
        want = rdist.blocked_to_full(want, g.n_nodes)
    elif mode == "dual_blocked_compact":
        c = np.asarray(want).reshape(-1)[:shards["n_hub"]]
        want = np.zeros(g.n_nodes)
        want[shards["nd_ids"]] = c
    assert np.abs(hf - want).max() < 1e-12
    assert np.abs(hf - oracle["accel"]).max() < 1e-12
    port = accel_hits(g, tol=1e-12, dtype="float64", device="cpu").v
    assert np.abs(hf - port).max() < 1e-12


@pytest.mark.parametrize("s,dtype", PSUM)
def test_psum_adds_in_xla_order(oracle, s, dtype):
    """``psum`` equals ``lax.psum`` over S forced host devices bit for bit:
    the shards folded in order 0..S-1 (bf16 parts in f32, rounded once);
    every shard holds the sum; the output bytes count as an all-reduce."""
    x = psum_parts(s, dtype)
    dt = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}[dtype]
    mesh = dist.make_mesh(s, device="cpu")
    out = dist.psum(mesh, [torch.from_numpy(r).to(dt) for r in x])
    want = oracle[f"psum/{s}/{dtype}"]
    for d in range(s):
        assert np.array_equal(out[d].double().numpy(), want[d])
    assert mesh.collective_bytes == {"all-reduce": 4000 * out[0].itemsize}


def test_ring_allreduce_equals_psum(oracle):
    """The chunked ring all-reduce (3 chunks, 8 shards) is the psum's sum,
    in ring order: allclose to ``psum`` and to the reference's ring. The
    53 rows pad to 3 chunks of 24 (8 pieces of 3 rows): each chunk takes
    7 collective permutes of a piece and one all-gather of the chunk."""
    x = torch.from_numpy(ring_input())
    mesh = dist.make_mesh(8, device="cpu")
    ring = dist.ring_allreduce_chunked(mesh, list(x), 3)
    assert mesh.collective_bytes == {"collective-permute": 3 * 7 * 3 * 8,
                                     "all-gather": 3 * 24 * 8}
    plain = dist.psum(mesh, list(x))
    for d in range(8):
        assert ring[d].shape == (53,)
        assert np.allclose(ring[d].numpy(), plain[d].numpy())
        assert np.allclose(ring[d].numpy(), oracle["ring"][d])
    one, part = dist.make_mesh(1, device="cpu"), x[0]
    assert dist.ring_allreduce_chunked(one, [part])[0] is part


@pytest.mark.parametrize("s", WIRE_SHARDS)
def test_measured_wire_bytes_ladder(oracle, s):
    """One sweep's wire bytes from the mesh's counters: dual_blocked <=
    replicated; replicated equals the analytic ladder and dual_blocked
    the ladder plus its normalising psum of V sums (where nb * S ==
    n_pad); both are half the reference's HLO reading, whose parser
    counts the entry computation twice (``launch.hlo_analysis``)."""
    g = graph()
    w = np.ones(g.n_edges)
    got = {}
    for mode in COL_MODES:
        be = ShardedSweepBackend(mode=mode, n_devices=s, device="cpu")
        got[mode] = be.measure_wire_bytes(N_PAD, V, g.src, g.dst, w)
        assert got[mode] == pytest.approx(oracle[f"wire/{mode}/{s}"] / 2)
    assert 0 < got["dual_blocked"] <= got["replicated"]
    # the analytic count is truncated to whole bytes
    frac = (s - 1) / s
    be = ShardedSweepBackend(mode="replicated", n_devices=s, device="cpu")
    assert 0 <= got["replicated"] - be.collective_bytes_per_sweep(N_PAD, V) \
        < 1
    if N_PAD % s == 0:
        be = ShardedSweepBackend(mode="dual_blocked", n_devices=s,
                                 device="cpu")
        assert 0 <= got["dual_blocked"] - 2 * V * 8 * frac \
            - be.collective_bytes_per_sweep(N_PAD, V) < 1


def test_mesh_placement_and_counters(monkeypatch):
    """Shard s goes on the (s % k)-th of k visible devices of the type
    (every shard on the host for "cpu"); shapes must hold the devices;
    ``reset_counters`` zeroes the bytes and segment sums."""
    mesh = dist.make_mesh(8, device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 8
    assert mesh.distinct_devices() == (torch.device("cpu"),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    cards = dist.make_mesh(8, device="cuda")
    assert [d.index for d in cards.devices] == [0, 1, 2, 0, 1, 2, 0, 1]
    assert len(cards.distinct_devices()) == 3
    with pytest.raises(ValueError):
        dist.Mesh(["cpu"] * 4, (2, 3), ("a", "b"))
    x = [torch.ones(5, dtype=torch.float64) for _ in range(8)]
    dist.all_gather(mesh, x)
    dist.psum(mesh, x)
    assert mesh.collective_bytes == {"all-gather": 320, "all-reduce": 40}
    mesh.reset_counters()
    assert mesh.collective_bytes == {} and mesh.segment_sums == 0


if __name__ == "__main__":
    compute_oracle(sys.argv[1])
