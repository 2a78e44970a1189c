#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

0. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` and print the build time and the
   compiler's register/spill report;
1. K1 (``bsr_scaled_matvec``) against its plain torch version on the card,
   at the main path's shape (the britannica union of 8 queries of 50 roots:
   n_pad 4096, bs 128, V 8; the blocks per block row are printed) in f64,
   f32 and bf16, plus bs 16 and V 1; a second run must give the same bits
   and leave the fold counters at 0; time per launch beside the bound and
   a PyTorch yardstick (``library_ms``);
2. the sweep epilogue (its two kernels) and K2 (``bsr_converge_cols``, one
   CUDA graph built, launched and destroyed per call) against their plain
   versions on the card: rank_k 0 and 10, ladder off and bf16; each K2
   call must show one graph build, one host read and 2 x (sweeps + 1) K1
   and epilogue launches, as the kernels count them on the device; K2's
   call time (events: buffers, build, launch, read), device time and graph
   build time;
2b. K3 (``seg_matmul``) through its path ``kernels.ops.seg_aggregate``
   (launch counter zeroed just before, read just after) on britannica's
   edges (bs 128, tile_e 256), seeded messages of widths 1, 8 and 64 in
   f32 and of width 8 in f64 and bf16; each case equal bit for bit to the
   plain version on the card and to a second run, and within a rounding
   bound of the f32 oracle ``seg_matmul_ref``; time per launch beside the
   byte bound and the ``index_add_`` yardstick;
3. the main path: ``RankService.rank`` on ``paper_dataset("britannica")``
   with the ``bsr`` backend on the card, 3 batches of 8 seeded queries of 50
   roots, a repeat batch served from cache, then a rank_k=10 service and a
   bf16-ladder service; every query is held to the same service on the CPU,
   and the launch counters (zeroed just before each run) must show one K2
   graph launch and one host read per batch, K1 and the epilogue launched
   2 x (sweeps + 1) times per batch; a profiled rerun must see as many K1
   and epilogue kernels on the device as the counters;
3b. live edge deltas on the f64 ``bsr`` service: the 3 batches, a
   weight-only delta (1 % of the first batch's union edges reweighted by
   2.0, drawn from the seed) and the same 24 queries again (the service
   must patch at least one plan, and build no cold plan for a union it
   patched), then a structural delta (adds and removes) and the queries
   again; every query held to a CPU service given the same deltas; the
   patch time beside a cold plan of the same union;
3c. the paper's whole-graph ``accel_hits`` and ``qi_hits`` on britannica,
   f64, tol 1e-10, on the card against the same calls on the CPU;
3d. the serving periphery on the main path's configuration: (a) a Zipf
   stream (``launch.serve_rank.zipf_query_stream``, seed 0, 48 requests
   of 50 roots) through ``svc.queue(deadline_ms=5)`` with Poisson
   arrivals, two priority classes and an SLA each; every served query
   held to a cold CPU ranking of its root set (1e-10 L1), class 0 sheds
   nothing, one K2 graph and one host read per swept batch; q/s and
   p50/p95 per class; (b) restart from the spill: a card service serves
   the 3 batches and flushes, a second restores its entries (the repeat
   stream all hits), a third with the vectors cleared sweeps through the
   restored plans to the first's bits; a built plan against a restored
   one (npz read + H2D) of the same union; a spill dir the port wrote on
   the CPU restored on the card; (c) ``python -m
   repro_torch.launch.serve_rank`` as a subprocess (queued frontend,
   ``--stats-port 0``, a spill dir, a 1-edge ``--delta-file``): /healthz,
   SIGHUP rolls the delta mid-stream, SIGTERM drains to exit 0, and a
   relaunch on the spill dir restores entries;
3e. the offline ranking path at full scale: (a) Table 7: ``qi_hits``,
   ``accel_hits`` and ``pagerank`` (f64, tol 1e-9) on the eight
   ``PAPER_TABLE7`` datasets at scale 1.0, original and back-button
   graphs, iters held to the JAX package's (``TABLE7_ITERS``), wall ms per
   run, britannica/wikipedia/jobs also held to the port on the host CPU
   (1e-10 L1, equal iters), the paper's claims and the cosine/Spearman
   agreement with QI-HITS printed as findings; (b) K1 on the whole graph:
   britannica's Lᵀ as 128 x 128 blocks (f32, no permutation: 27,214
   blocks): one K1 call bit-equal to its plain version, K1's device time
   per launch beside its byte bound, the plain version and
   ``torch.sparse_bsr_tensor @``; then ``kernels.ops.hits_sweep_bsr`` (K1's
   link form): ``iters + 5`` sweeps (2 link-form launches each, counted,
   no blocked K1) within 1e-4 of the card's ``RankingEngine`` hub, and one
   segment-sum sweep (``core.hits.hits_sweep``) of the same graph; (c) ``core.power.power_method_jit`` (one CUDA graph, a WHILE
   node over the captured f64 K1 sweep) against ``power_method``; (d)
   ``RankingEngine`` on the card against the CPU, with and without
   stragglers, and ``python -m repro_torch.launch.rank`` (britannica,
   back-button, a checkpoint every 2 sweeps), then ``--resume``; (e) K1's
   link form at the whole-crawl cells' shapes (``link_form_phase``);
3f. the sharded backend (``sparse/dist.py``): both modes at S 1, 2, 4
   logical shards, every query held to a CPU dense service, host reads
   and wire bytes per sweep, a delta, a spill, the whole graph on a (4,
   2) mesh (``sharded_phase``);
3g. the example ports and the recsys family (``recsys_phase``): the five
   ``examples/*_torch.py`` on the card held to the JAX package's lines
   (``EXAMPLE_LINES``); each recsys architecture at its published widths
   (rows cut, ``RECSYS_ROWS_CUT``) against the host CPU; dlrm-rm2,
   dcn-v2 and bst trained 20 steps through ``launch.train`` at full
   config and batch 65,536 (bst checkpointed and resumed), dlrm-rm2's
   step split, the two-tower trained in process; retrieval at the full
   two-tower config over 1M candidates with the accelerated-HITS prior;
3h. the LM family (``lm_phase``): the five smoke configs against the host
   CPU, decode at full width, minitron-4b training, the LM examples;
3i. the GNN family (``gnn_phase``): gin-tu's smoke config against the
   host CPU in its three modes; the aggregation (K3 forward and backward)
   bit-equal to its plain version at Cora's shape, ogb_products (its
   first and last blocks), a minibatch_lg block and a molecule batch;
   full-graph training at ogb_products' published counts (K3 two
   launches a layer a step, counted), sampled minibatch_lg steps and
   batched molecule steps, and ``launch.train --arch gin-tu``;
3j. the dry-run and roofline tools (``dryrun_phase``): ``python -m
   repro_torch.launch.dryrun`` as subprocesses, one cell of each family
   on the pod1 mesh (minitron-4b train_4k, gin-tu ogb_products,
   dlrm-rm2 train_batch, hits-webgraph webrank_200m) and two on a
   one-card host mesh, whose roofline step time (H100 data-sheet rates)
   is printed beside 3i (c)'s and 3g's measured steps; every cell must be
   ``ok``;
4. a ``{"kernels": [...]}`` line (K1's entry carries the whole-graph
   blocked numbers under ``hits_sweep_bsr``, ``links_spmm`` the link
   form's at each whole-crawl cell under ``cells``, K3's the GNN's under
   ``gnn``), then the contract's last line.

It imports torch, numpy and the port only. K1's and K3's ``ms`` is the
kernel's device time per launch and the epilogue's the device time of
its two kernels, from the profiler; K2's ``ms`` is its call time, graph
build included, as every main-path batch pays it;
``call_ms`` (printed) and every other time come from CUDA events over
repeated calls after a warm-up, so they include the host's time to
launch. Bounds are computed
from this run's inputs against the H100 SXM data-sheet peaks below.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
L2_BYTES = 50 * 2 ** 20    # H100 SXM L2
# peak rate per operand type: bf16 dense tensor cores and f32 outside the
# tensor cores; f64 tensor cores (H100 SXM data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 67e12}
# The JAX package's iters (qi_hits, accel_hits, pagerank) for Table 7's
# datasets at scale 1.0, f64, tol 1e-9, on the original (orig) and the
# back-button (bb) graphs; made on the CPU with
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   import jax; jax.config.update('jax_enable_x64', True)
#   from repro.core import accel_hits, back_button, pagerank, qi_hits
#   from repro.graph import PAPER_TABLE7, paper_dataset
#   for n in PAPER_TABLE7:
#       g = paper_dataset(n, 1.0)
#       for t, gg in (('orig', g), ('bb', back_button(g))):
#           print(n, t, [f(gg, tol=1e-9).iters
#                        for f in (qi_hits, accel_hits, pagerank)])"
TABLE7_ITERS = {
    ("britannica", "orig"): (10, 9, 7), ("britannica", "bb"): (73, 8, 66),
    ("jobs", "orig"): (11, 9, 7), ("jobs", "bb"): (130, 8, 88),
    ("opera", "orig"): (9, 8, 6), ("opera", "bb"): (151, 6, 95),
    ("python", "orig"): (9, 8, 6), ("python", "bb"): (310, 10, 95),
    ("scholarpedia", "orig"): (9, 9, 8), ("scholarpedia", "bb"): (160, 11, 71),
    ("stanford", "orig"): (9, 8, 6), ("stanford", "bb"): (230, 9, 100),
    ("wikipedia", "orig"): (13, 9, 6), ("wikipedia", "bb"): (215, 15, 104),
    ("yahoo", "orig"): (10, 9, 5), ("yahoo", "bb"): (420, 12, 114),
}
# datasets whose card vectors are also held to the port on the host CPU
TABLE7_ON_CPU = ("britannica", "wikipedia", "jobs")
# The JAX package's deterministic lines of the ranking examples, made on
# the CPU with
#   for e in quickstart webgraph_ranking_e2e query_ranking_service \
#            async_ranking_clients retrieval_with_hits; do
#     PYTHONPATH=src JAX_PLATFORMS=cpu python examples/$e.py; done
EXAMPLE_LINES = {
    "quickstart": {
        "crawl": "synthetic 'wikipedia' crawl: 3129 pages, 7529 links, "
                 "96% dangling",
        "iters": [13, 9, 6, 159, 17, 104],
        "agreement": "agreement with QI-HITS: cosine=0.951 spearman=0.992",
        "bb": "L* = L + M: 14802 links, 41% dangling",
        "top5": [1565, 308, 585, 2312, 683]},
    "webgraph_ranking_e2e": {
        "graph": "graph: N=33816 E=350980 dangling=30.4%",
        "engine": (23, 47), "refine": (343, 345),
        "spearman": "spearman=1.0000"},
    "query_ranking_service": {
        "graph": "graph: N=4220 E=86677 dangling=85.0%",
        "cold": [(16, 27, [2056, 914, 4188]), (8, 61, [400, 314, 201]),
                 (8, 96, [400, 1261, 314]), (8, 80, [201, 400, 314])],
        "top3": [[0.1277597613671264, 0.11321241229920358,
                  0.10794777069036801],
                 [0.04440675223383055, 0.04440617920815661,
                  0.04409223717109805],
                 [0.03225171448235673, 0.03225171448235673,
                  0.03225159307198242],
                 [0.04329123821412148, 0.04329123821412148,
                  0.04329105227831447]],
        "warm": [(1, 16), (1, 8), (1, 8), (1, 8)]},
    "async_ranking_clients": {
        "graph": "graph: N=4000 E=24782", "restored": 21},
    "retrieval_with_hits": {
        "graph": "interaction graph: 2000 users, 3000 items, 26547 "
                 "interactions",
        "hits": "accelerated HITS: 10 iters; top item authority=0.06389"},
}


def example_problems(name, out):
    """What in an example port's output (``examples/<name>_torch.py``)
    departs from the JAX package's lines (``EXAMPLE_LINES``): an empty
    list when nothing does. Timings and paths are not compared; the
    query service's scores within 1e-12 and its oracle L1 within 1e-10;
    the async clients' counters (timing-dependent) must account for all
    48 tickets."""
    import ast
    import re
    want = EXAMPLE_LINES[name]
    lines = out.splitlines()
    bad = []

    def has(text):
        if not any(x.strip() == text for x in lines):
            bad.append(f"missing line {text!r}")

    def grab(pattern, conv=int):
        m = re.findall(pattern, out)
        if not m:
            bad.append(f"no match for {pattern!r}")
        return [tuple(map(conv, x)) if isinstance(x, tuple) else conv(x)
                for x in m]

    if name == "quickstart":
        for k in ("crawl", "agreement", "bb"):
            has(want[k])
        iters = grab(r"(\d+) iterations")
        if iters != want["iters"]:
            bad.append(f"iters {iters}")
        if grab(r"page\s+(\d+)\s+authority") != want["top5"]:
            bad.append("top-5 pages differ")
    elif name == "webgraph_ranking_e2e":
        has(want["graph"])
        if grab(r"accelerated HITS: (\d+) iters.*stale_events=(\d+)") \
                != [want["engine"]]:
            bad.append("engine iters/stale events differ")
        if grab(r"refinement: (\d+) warm-start iters vs (\d+) from") \
                != [want["refine"]]:
            bad.append("QI-HITS refinement iters differ")
        if want["spearman"] not in out:
            bad.append("spearman differs")
    elif name == "query_ranking_service":
        has(want["graph"])
        cold = re.findall(r"\[(\w+), (\d+) sweeps, (\d+) focused pages\] "
                          r"top-3 (\[.*\])", out)
        got = [(int(i), int(n), [a for a, _ in ast.literal_eval(t)])
               for st, i, n, t in cold]
        if got != want["cold"] or any(c[0] != "cold" for c in cold):
            bad.append(f"cold burst {got}")
        for c, w in zip(cold, want["top3"]):
            s = [b for _, b in ast.literal_eval(c[3])]
            if max(abs(x - y) for x, y in zip(s, w)) > 1e-12:
                bad.append(f"top-3 scores {s}")
        if "4/4 cache hits" not in out or "identical scores: True" not in out:
            bad.append("repeat burst not 4/4 identical hits")
        w = re.findall(r"warm refresh sweeps vs cold: (\[.*\])", out)
        if not w or ast.literal_eval(w[0]) != want["warm"]:
            bad.append(f"warm refresh {w}")
        l1 = grab(r"oracle: L1=(\S+)", float)
        if not l1 or not l1[0] <= 1e-10:
            bad.append(f"oracle L1 {l1}")
    elif name == "async_ranking_clients":
        has(want["graph"])
        n = grab(r"(\d+) queries from (\d+) concurrent")
        co = grab(r"(\d+) coalesced in flight")
        c = grab(r"cache: (\d+) hits / (\d+) warm / (\d+) cold")
        if n != [(48, 4)] or not co or not c or sum(c[0]) + co[0] != 48:
            bad.append(f"tickets {n}, coalesced {co}, counters {c}")
        if grab(r"restored (\d+) spilled") != [want["restored"]] or \
                "['hit', 'hit', 'hit', 'hit'] (4 served" not in out:
            bad.append("restart did not serve the repeats from the spill")
    elif name == "retrieval_with_hits":
        has(want["graph"])
        has(want["hits"])
        loss = grab(r"two-tower trained: loss=(\S+)", float)
        m = grab(r"base=(\S+) blended=(\S+)", float)
        if not loss or not np.isfinite(loss[0]) or not m or \
                not m[0][1] > m[0][0]:
            bad.append(f"loss {loss}, mean authority {m}")
    return bad


# The LM example ports' lines: the reference's formats and sizes (their
# init, prompts and batches come from seeded torch Generators, so tokens
# and losses are not the JAX package's bits); made from
#   PYTHONPATH=src JAX_PLATFORMS=cpu python examples/serve_decode.py
#   PYTHONPATH=src JAX_PLATFORMS=cpu python examples/train_lm.py --steps 21
LM_EXAMPLE_LINES = {
    "serve_decode": {"args": [], "prompt": 6, "gen": 24, "vocab": 128,
                     "served": r"served batch=8: 192 tokens in \S+s \(\S+ "
                               r"tok/s, rolling SWA cache len=16\)"},
    "train_lm": {"args": ["--steps", "21"],
                 "model": "model: 8.1M params (demo-20m)", "steps": [0, 20]},
}


def lm_example_problems(name, out):
    """What in an LM example's output departs from the reference's lines
    (``LM_EXAMPLE_LINES``): the serving line and a sample of 6 prompt
    tokens -> 24 generated in the vocab; the trainer's model line and
    step lines, finite losses, the last below the first."""
    import ast
    import re
    want = LM_EXAMPLE_LINES[name]
    bad = []
    if name == "serve_decode":
        if not re.search(want["served"], out):
            bad.append("no served line")
        m = re.search(r"sample: (\[.*\]) -> (\[.*\])", out)
        if not m:
            return bad + ["no sample line"]
        p, g = ast.literal_eval(m.group(1)), ast.literal_eval(m.group(2))
        if len(p) != want["prompt"] or len(g) != want["gen"] or not all(
                0 <= t < want["vocab"] for t in p + g):
            bad.append(f"sample {p} -> {g}")
    else:
        if want["model"] not in out.splitlines():
            bad.append("no model line")
        steps = re.findall(r"step\s+(\d+) loss (\S+) \((\S+) steps/s\)", out)
        loss = [float(x[1]) for x in steps]
        if [int(x[0]) for x in steps] != want["steps"] or not all(
                np.isfinite(loss)) or not loss[-1] < loss[0]:
            bad.append(f"steps {steps}")
    return bad


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def ms(fn, n):
    """Mean ms per call of fn over n calls after two warm-up calls (CUDA
    events: the host's time to launch included)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def device_ms(fn, n, kernel=None, per_call=False):
    """Mean device ms of one launch of the kernels whose names hold
    ``kernel`` over n calls of fn after a warm-up, from the profiler's
    device times: the kernels' own time, apart from the host's time to
    launch them (``per_call``: their total per call of fn). With
    ``kernel`` None: the device time of every kernel and copy of a call,
    per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if kernel is None or kernel in e.key:
            t = getattr(e, "self_device_time_total", None)
            t = t if t is not None else e.self_cuda_time_total
            us += t
            count += e.count if t else 0
    if kernel is None or per_call:
        count = n
    return us / 1e3 / count if count else float("nan")


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        fail(f"{ROOT} is not a checkout of the repo (src/repro_torch missing)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.kernels import ops as O
    from repro_torch.kernels.ref import seg_matmul_ref
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_matmul_plain
    from repro_torch.core import accel_hits, qi_hits
    from repro_torch.serve import (BsrSweepBackend, RankService,
                                   RankServiceConfig)
    from repro_torch.serve.pipeline import PipelineJob
    from repro_torch.graph import paper_dataset
    from torch.profiler import ProfilerActivity, profile

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    # ---------------------------------------------------------- 0. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"[build] {time.perf_counter() - t0:.1f} s wall "
          f"(nvcc {build.build_seconds})", flush=True)
    for name in build.SOURCES:
        for line in build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas {name}]", line.strip())

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # main-path inputs: the first batch's union, planned by the bsr backend
    g = paper_dataset("britannica", 1.0)
    rng = np.random.default_rng(SEED)
    queries = [rng.choice(g.n_nodes, size=50, replace=False)
               for _ in range(24)]
    cfg = dict(backend="bsr", v_max=8, dtype="float64", tol=1e-10)
    probe = RankService(g, RankServiceConfig(device="cuda", **cfg))
    asm = probe.pipeline.assemble(PipelineJob(
        queries=[probe.validate_roots(q) for q in queries[:8]]))
    batch = asm.batch
    plan = BsrSweepBackend(bs=128, device="cuda").plan(batch)
    perm = plan.perm_dev
    h0, ca, ch, m = (torch.from_numpy(x).to(dev).index_select(0, perm)
                     .contiguous() for x in (batch.h0, batch.ca, batch.ch,
                                             batch.mask))
    lt, lf = plan.lt.operand, plan.lfwd.operand
    n_pad, v = h0.shape
    nblk = (lt.blocks.shape[0], lf.blocks.shape[0])

    def per_row(op):
        """Blocks per block row: min/median/max, rows of one block, and the
        five densest rows (K1's fold is as long as its densest row)."""
        c = np.diff(op.row_ptr.cpu().numpy())
        return (f"min {c.min()} median {int(np.median(c))} max {c.max()}, "
                f"{int((c == 1).sum())} of {c.size} rows of one block, "
                f"densest {sorted(c.tolist())[-5:][::-1]}")
    print(f"[main-path shape] union n_pad={n_pad} V={v} bs={plan.bs} "
          f"blocks Lt={nblk[0]} L={nblk[1]} "
          f"({nbytes(lt.blocks) / 1e6:.1f} MB per f64 operator); blocks per "
          f"block row: Lt {per_row(lt)}; L {per_row(lf)}", flush=True)
    torch.cuda.synchronize()

    # ------------------------------------------------------------- 1. K1
    # tolerances, relative to max|y_plain|: f64 sums of <= 128 products per
    # block in two orders (~1e-14 apart); f32/bf16 accumulate in f64 and
    # round once, so they differ only where two f64 sums straddle a rounding
    # boundary, by an ulp that the row's running sum can carry: 8 f32 ulps,
    # 4 bf16 ulps
    tol_k1 = {"float64": 1e-13, "float32": 2.0 ** -20, "bfloat16": 2.0 ** -6}
    k1 = {}
    for name, dt in (("float64", torch.float64), ("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        ops = [(o.blocks.to(dt), o.idx, o.row_ptr) for o in (lt, lf)]
        x, cin, mk = (t.to(dt) for t in (h0, ch, m))
        # one workspace for every launch, as the K2 loop keeps it
        scr = K.Scratch(dev)
        y = K.bsr_scaled_matvec(*ops[0], x, cin, bs=plan.bs, mask=mk,
                                scratch=scr)
        y2 = K.bsr_scaled_matvec(*ops[0], x, cin, bs=plan.bs, mask=mk,
                                 scratch=scr)
        yp = K.bsr_scaled_matvec_plain(*ops[0], x, cin, bs=plan.bs, mask=mk)
        torch.cuda.synchronize()
        err = (y.double() - yp.double()).abs().max().item()
        scale = yp.double().abs().max().item()
        check(err <= tol_k1[name] * scale,
              f"K1 {name}: max|y - plain| = {err:.3e} > "
              f"{tol_k1[name]:.1e} * {scale:.3e}")
        check(torch.equal(y, y2) and not scr.cnt.any(),
              f"K1 {name}: two runs differ or the fold counters are not 0")
        # the loop alternates Lᵀ and L (together larger than L2): time pairs
        kern = lambda: [K.bsr_scaled_matvec(*o, x, cin, bs=plan.bs, mask=mk,  # noqa: E731
                                            scratch=scr) for o in ops]
        plain = lambda: [K.bsr_scaled_matvec_plain(*o, x, cin, bs=plan.bs,  # noqa: E731
                                                   mask=mk) for o in ops]
        # call_ms: a call as the host sees it (CUDA events), launch
        # overhead included; ms: the kernel's own device time per launch
        t_call = ms(kern, 20) / 2
        t_k = device_ms(kern, 20, "bsr_spmm_kernel")
        t_p = ms(plain, 3) / 2
        moved = sum(nbytes(*o) for o in ops) / 2 + nbytes(x, cin, mk, y)
        flops = 2.0 * sum(nblk) / 2 * plan.bs * plan.bs * v
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        # yardstick: one PyTorch call for A @ (x ⊙ cin), the BSR product
        xs = (x * cin)
        mats = [torch.sparse_bsr_tensor(o[2].long(), o[1][:, 1].long(),
                                        o[0], size=(n_pad, n_pad))
                for o in ops]
        lib_kind = "torch.sparse_bsr_tensor @ dense"
        try:
            mats[0] @ xs
        except (RuntimeError, NotImplementedError) as e:
            print(f"[K1 {name}] sparse BSR matmul unavailable "
                  f"({str(e).splitlines()[0]}); yardstick is dense matmul")
            mats = [sp.to_dense() for sp in mats]
            lib_kind = "dense torch.matmul"
        t_lib = ms(lambda: [a @ xs for a in mats], 20) / 2
        t_lib_dev = device_ms(lambda: [a @ xs for a in mats], 20) / 2
        k1[name] = dict(err=err, ms=t_k, call_ms=t_call, plain_ms=t_p,
                        library_ms=t_lib,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[K1 {name}] max_abs_err={err:.3e} ms={t_k:.4f} "
              f"(device; call_ms={t_call:.4f}) "
              f"plain_ms={t_p:.4f} library_ms={t_lib:.4f} (device "
              f"{t_lib_dev:.4f}; {lib_kind}) "
              f"bound_ms={max(t_bytes, t_ops):.4f} "
              f"({moved / 1e6:.1f} MB at 3.35 TB/s) "
              f"-> {moved / (t_k * 1e-3) / 1e12:.2f} TB/s", flush=True)
    # small shapes: bs 16, V 1 (a (n_pad, 1) shared diagonal)
    from repro_torch.graph.structure import Graph
    from repro_torch.kernels.ops import DeviceBSR
    real = batch.w != 0
    inv = plan.inv
    gp = Graph(n_pad, inv[batch.src[real]], inv[batch.dst[real]])
    small = DeviceBSR.build(gp, 16, transpose=True, dtype="float64",
                            values=batch.w[real], device=dev)
    for vv in (1, 3):
        x1 = h0[:, :vv].contiguous()
        c1 = ch[:, :1].contiguous()
        y = K.bsr_scaled_matvec(small.blocks, small.idx, small.row_ptr, x1,
                                c1, bs=16)
        yp = K.bsr_scaled_matvec_plain(small.blocks, small.idx,
                                       small.row_ptr, x1, c1, bs=16)
        err = (y - yp).abs().max().item()
        check(err <= 1e-13 * yp.abs().max().item(),
              f"K1 bs=16 V={vv}: max err {err:.3e}")
        print(f"[K1 bs=16 V={vv} cin (n_pad,1)] {small.blocks.shape[0]} blocks "
              f"max_abs_err={err:.3e}")

    # -------------------------------------------- 2. epilogue and K2
    # one sweep's epilogue on identical state, kernel vs plain
    a = K.bsr_scaled_matvec(*lt, h0, ch, bs=plan.bs, mask=m)
    hr = K.bsr_scaled_matvec(*lf, a, ca, bs=plan.bs, mask=m)
    ep = {}
    for rk in (0, 10):
        states, hs = [], []
        for _ in range(2):
            ctl = torch.zeros(2, dtype=torch.int32, device=dev)
            states.append(K.LoopState.start(ctl, v, rk, 1000))
            hs.append(h0.clone())
        K.sweep_epilogue(hr, hs[0], a, states[0], tol=1e-10,
                         stable_sweeps=2, max_iter=1000)
        K.sweep_epilogue_plain(hr, hs[1], a, states[1], tol=1e-10,
                               stable_sweeps=2, max_iter=1000)
        torch.cuda.synchronize()
        err = (hs[0] - hs[1]).abs().max().item()
        for f in ("ctl", "conv", "stop", "stab", "top"):
            check(torch.equal(getattr(states[0], f), getattr(states[1], f)),
                  f"epilogue rank_k={rk}: {f} differs from the plain version")
        check(err <= 1e-15, f"epilogue rank_k={rk}: h differs by {err:.3e}")
        # tol -1 and large stable_sweeps and max_iter keep the flag set
        # across repeats (a stopped loop's epilogue returns at once)
        st = K.LoopState.start(torch.zeros(2, dtype=torch.int32, device=dev),
                               v, rk, 10 ** 9)
        hk = h0.clone()

        def epi():
            K.sweep_epilogue(hr, hk, a, st, tol=-1.0, stable_sweeps=10 ** 9,
                             max_iter=10 ** 9)
        # ms: the device time of one epilogue (its two kernels); call_ms
        # adds the wrapper's host work
        t_k = device_ms(epi, 50, "ep_", per_call=True)
        t_call = ms(epi, 50)
        check(int(st.ctl[0]) == 1, f"epilogue rank_k={rk}: the timed loop "
              "stopped, so the timing read no-op launches")
        st_p = K.LoopState.start(torch.zeros(2, dtype=torch.int32,
                                             device=dev), v, rk, 10 ** 9)
        hp = h0.clone()
        t_p = ms(lambda: K.sweep_epilogue_plain(hr, hp, a, st_p, tol=-1.0,
                                                stable_sweeps=10 ** 9,
                                                max_iter=10 ** 9), 5)
        moved = nbytes(hr, hk, hk) + (nbytes(a) if rk else 0)
        ep[rk] = dict(err=err, ms=t_k, call_ms=t_call, plain_ms=t_p,
                      bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        print(f"[epilogue rank_k={rk}] max_abs_err={err:.3e} ms={t_k:.4f} "
              f"(device, both kernels; call_ms={t_call:.4f}) "
              f"plain_ms={t_p:.4f} bound_ms={ep[rk]['bound_ms']:.5f} "
              f"({st.ep.slices} slices of {st.ep.rows} rows)", flush=True)

    lo = {o: K.BsrOperand(getattr(plan, o).blocks.to(torch.bfloat16),
                          getattr(plan, o).idx, getattr(plan, o).row_ptr)
          for o in ("lt", "lfwd")}
    op_bytes = nbytes(*lt) + nbytes(*lf)
    k2 = {}
    for rk in (0, 10):
        for bulk in (None, "bfloat16"):
            kw = dict(bs=plan.bs, max_iter=1000, rank_k=rk, stable_sweeps=2)
            if bulk:
                kw.update(lt_lo=lo["lt"], lf_lo=lo["lfwd"], bulk_dtype=bulk,
                          bulk_tol=max(1e-10, 1e3 * 2.0 ** -7))
            K.reset_counters()
            out = K.bsr_converge_cols(lt, lf, h0, ca, ch, m, 1e-10, **kw)
            torch.cuda.synchronize()
            counts = K.counters.as_dict()
            ref = K.bsr_converge_cols_plain(lt, lf, h0, ca, ch, m, 1e-10,
                                            **kw)
            dh = (out[0] - ref[0]).abs().sum(0).max().item()
            da = (out[1] - ref[1]).abs().sum(0).max().item()
            sweeps = int(out[2].max())
            check(torch.equal(out[2], ref[2]),
                  f"K2 rank_k={rk} ladder={bulk}: conv {out[2].tolist()} vs "
                  f"plain {ref[2].tolist()}")
            check(dh <= 1e-10 and da <= 1e-10,
                  f"K2 rank_k={rk} ladder={bulk}: L1 h {dh:.3e} a {da:.3e}")
            check(counts["host_syncs"] == 1 and counts["k2_graph_builds"] == 1
                  and counts["bsr_spmm"] == 2 * (sweeps + 1)
                  and counts["sweep_epilogue"] == 2 * (sweeps + 1),
                  f"K2 rank_k={rk} ladder={bulk}: {sweeps} sweeps as "
                  f"{counts}, not one graph launch with one host read")
            entry = dict(err=max(dh, da), sweeps=sweeps,
                         syncs=counts["host_syncs"],
                         launches=counts["bsr_spmm"])
            if rk == 0 and bulk is None:
                # call_ms: a call as the main path makes it (buffers, graph
                # build, one launch, the host read, the graph's destroy)
                call = lambda: K.bsr_converge_cols(  # noqa: E731
                    lt, lf, h0, ca, ch, m, 1e-10, **kw)
                entry["call_ms"] = ms(call, 10)
                entry["device_ms"] = device_ms(call, 5)
                # a call's host time, step by step (host clock): buffers,
                # the builder's arguments, graph build (capture plus
                # instantiate), launch plus the read (which waits for the
                # device), destroy
                steps = dict.fromkeys(("buffers", "args", "build",
                                       "launch_read", "destroy"), 0.0)
                for _ in range(5):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    bufs = K.K2Buffers(
                        lt, lf, None, None, h0, ca, ch, m, bs=plan.bs,
                        bulk_dtype=None, k_eff=0, tol=1e-10, bulk_tol=0.0,
                        max_iter=1000, stable_sweeps=2)
                    t1 = time.perf_counter()
                    gr = K.K2Graph(bufs)
                    t2 = time.perf_counter()
                    gr.run()
                    t3 = time.perf_counter()
                    gr.destroy()
                    t4 = time.perf_counter()
                    for k_, dt_ in zip(steps, (
                            t1 - t0, t2 - t1 - gr.build_ms / 1e3,
                            gr.build_ms / 1e3, t3 - t2, t4 - t3)):
                        steps[k_] += dt_ * 1e3 / 5
                entry["build_ms"] = steps["build"]
                entry["steps"] = steps
                entry["plain_ms"] = ms(lambda: K.bsr_converge_cols_plain(
                    lt, lf, h0, ca, ch, m, 1e-10, **kw), 1)
                # bound: each input read once and each output written once,
                # or this run's flops ((sweeps + 1) sweeps of both K1s).
                # Beside it, the bytes if L2 kept nothing between sweeps
                # (reread_ms) and the least re-reading a 50 MiB L2 allows
                # (l2_ms): the two f64 operators are larger than L2
                moved = op_bytes + nbytes(h0, ca, ch, m, out[0], out[1],
                                          out[2], out[3])
                t_bytes = moved / HBM_BYTES_PER_S * 1e3
                t_ops = (sweeps + 1) * 2.0 * sum(nblk) * plan.bs ** 2 * v \
                    / PEAK_FLOPS["float64"] * 1e3
                entry["bound_ms"] = max(t_bytes, t_ops)
                entry["bound_by"] = "bytes" if t_bytes >= t_ops \
                    else "operations"
                entry["reread_ms"] = (sweeps + 1) * op_bytes \
                    / HBM_BYTES_PER_S * 1e3
                entry["l2_ms"] = (op_bytes + sweeps * max(
                    0, op_bytes - L2_BYTES)) / HBM_BYTES_PER_S * 1e3
            k2[(rk, bulk)] = entry
            print(f"[K2 rank_k={rk} ladder={bulk}] sweeps={sweeps} "
                  f"K1 launches={counts['bsr_spmm']} epilogue launches="
                  f"{counts['sweep_epilogue']} host_syncs="
                  f"{counts['host_syncs']} graph builds="
                  f"{counts['k2_graph_builds']} conv={out[2].tolist()} "
                  f"L1 h={dh:.2e} a={da:.2e}"
                  + (f" call_ms={entry['call_ms']:.4f} (events: buffers, "
                     f"graph build, launch, read) device_ms="
                     f"{entry['device_ms']:.4f} graph_build_ms="
                     f"{entry['build_ms']:.4f} (host ms per step: "
                     + " ".join(f"{k_}={v_:.4f}" for k_, v_
                                in entry["steps"].items())
                     + ") plain_ms="
                     f"{entry['plain_ms']:.3f} bound_ms="
                     f"{entry['bound_ms']:.4f} ({entry['bound_by']}: "
                     f"{op_bytes / 1e6:.1f} MB of operators read once) "
                     f"reread_ms={entry['reread_ms']:.4f} (if L2 kept "
                     f"nothing: (sweeps + 1) x the operators) l2_ms="
                     f"{entry['l2_ms']:.4f} (re-reading what a 50 MiB L2 "
                     "cannot hold)"
                     if "call_ms" in entry else ""), flush=True)

    # -------------------------------------------- 2b. K3 (seg_aggregate)
    tdt = {"float64": torch.float64, "float32": torch.float32,
           "bfloat16": torch.bfloat16}
    bs3, tile_e = 128, 256
    seg = O.build_tiled_segments(g.dst, g.n_nodes, bs=bs3, tile_e=tile_e)
    n_blocks, e_pad = seg["n_blocks"], seg["e_pad"]
    blkid_d, off_d, valid_d = (torch.from_numpy(np.ascontiguousarray(
        seg[k], np.int32)).to(dev) for k in ("blkid", "off", "valid"))
    tile_ptr = O.tile_ptr_of(seg["blkid"], n_blocks)
    tile_ptr_d = torch.from_numpy(tile_ptr).to(dev)
    tiles_of_blk = np.diff(tile_ptr)
    print(f"[K3 shape] britannica E={g.n_edges} n_blocks={n_blocks} "
          f"n_tiles={len(seg['blkid'])} e_pad={e_pad} tiles per block "
          f"max {tiles_of_blk.max()}", flush=True)
    # per destination row: its messages and its block's tiles, for the
    # rounding bound against the f32 oracle
    n_row = torch.from_numpy(np.bincount(g.dst, minlength=n_blocks * bs3)
                             .astype(np.float64)).to(dev)[:, None]
    tiles_row = torch.from_numpy(np.repeat(tiles_of_blk, bs3).astype(
        np.float64)).to(dev)[:, None]
    k3_cases = [(1, "float32"), (8, "float32"), (64, "float32"),
                (8, "float64"), (8, "bfloat16")]
    rng3 = np.random.default_rng(SEED + 3)
    host_msgs = {f: rng3.standard_normal((g.n_edges, f)) for f in (1, 8, 64)}
    msgs = {(f, dt): torch.from_numpy(host_msgs[f]).to(dev, tdt[dt])
            for f, dt in k3_cases}
    torch.cuda.synchronize()
    K.reset_counters()
    agg = {c: O.seg_aggregate(msgs[c], seg, bs=bs3, n_nodes=g.n_nodes)
           for c in k3_cases}
    torch.cuda.synchronize()
    k3_launches = K.counters.seg_matmul
    check(k3_launches == len(k3_cases),
          f"seg_aggregate launched K3 {k3_launches} times for "
          f"{len(k3_cases)} calls")
    dst_d = torch.from_numpy(g.dst).to(dev)
    k3 = {}
    scr3 = K.Scratch(dev)  # one workspace for every call, as seg_aggregate
    for f, name in k3_cases:
        m = O.pad_messages(msgs[(f, name)], seg).contiguous()
        y = seg_matmul(blkid_d, m, off_d, valid_d, n_blocks, bs=bs3,
                       tile_ptr=tile_ptr_d, scratch=scr3)
        y2 = seg_matmul(blkid_d, m, off_d, valid_d, n_blocks, bs=bs3,
                        tile_ptr=tile_ptr_d, scratch=scr3)
        yp = seg_matmul_plain(blkid_d, m, off_d, valid_d, n_blocks, bs=bs3)
        torch.cuda.synchronize()
        err = (y.double() - yp.double()).abs().max().item()
        check(torch.equal(y, yp),
              f"K3 F={f} {name}: kernel differs from the plain version "
              f"(max {err:.3e})")
        check(torch.equal(y, y2) and not scr3.cnt.any(),
              f"K3 F={f} {name}: two runs differ or the fold counters are "
              "not 0")
        check(torch.equal(y[:g.n_nodes], agg[(f, name)]),
              f"K3 F={f} {name}: seg_aggregate differs from seg_matmul")
        # the f32 oracle sums each row in another order: both stay within
        # (n - 1) f32 roundings of sum|m| of the exact sum, and the kernel
        # adds one rounding per tile (bf16: to bf16 per tile and per add)
        ref = seg_matmul_ref(blkid_d, m, off_d, valid_d, n_blocks, bs3)
        rowabs = seg_matmul_ref(blkid_d, m.abs(), off_d, valid_d, n_blocks,
                                bs3).double()
        bound = (2 * n_row + 2 * tiles_row + 2) * 2.0 ** -24 * rowabs
        if name == "bfloat16":
            bound = bound + (2 * tiles_row + 1) * 2.0 ** -8 * rowabs
        gap = (y.double() - ref.double()).abs()
        check(bool((gap <= bound).all()),
              f"K3 F={f} {name}: off the oracle by more than its rounding "
              f"bound ({(gap - bound).max().item():.3e} over)")
        def kern():
            return seg_matmul(blkid_d, m, off_d, valid_d, n_blocks, bs=bs3,
                              tile_ptr=tile_ptr_d, scratch=scr3)
        t_call = ms(kern, 20)
        t_k = device_ms(kern, 20, "seg_matmul_kernel")
        t_p = ms(lambda: seg_matmul_plain(blkid_d, m, off_d, valid_d,
                                          n_blocks, bs=bs3), 2)
        # the yardstick adds the E real messages, unpadded, into their rows
        raw = msgs[(f, name)]
        zeros = torch.zeros((n_blocks * bs3, f), dtype=m.dtype, device=dev)
        t_lib = ms(lambda: zeros.clone().index_add_(0, dst_d, raw), 20)
        t_lib_dev = device_ms(
            lambda: zeros.clone().index_add_(0, dst_d, raw), 20)
        # the function reads each edge's message row and destination
        # index once and writes y once
        moved = (g.n_edges * f * m.element_size() + 4 * g.n_edges
                 + nbytes(y))
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = g.n_edges * f / PEAK_FLOPS["float32"] * 1e3
        k3[(f, name)] = dict(err=err, ms=t_k, call_ms=t_call, plain_ms=t_p,
                             library_ms=t_lib, bound_ms=max(t_bytes, t_ops),
                             bound_by="bytes" if t_bytes >= t_ops
                             else "operations")
        print(f"[K3 F={f} {name}] max_abs_err={err:.3e} (bit-equal) "
              f"oracle gap {gap.max().item():.3e} ms={t_k:.4f} "
              f"(device; call_ms={t_call:.4f}) "
              f"plain_ms={t_p:.4f} library_ms={t_lib:.4f} (device "
              f"{t_lib_dev:.4f}; clone + index_add_) "
              f"bound_ms={max(t_bytes, t_ops):.4f} ({moved / 1e6:.1f} MB "
              f"at 3.35 TB/s) -> {moved / (t_k * 1e-3) / 1e12:.2f} TB/s",
              flush=True)
    del msgs, agg

    # ----------------------------------------------------- 3. main path
    def serve(extra, label):
        svc = RankService(g, RankServiceConfig(device="cuda", **cfg, **extra))
        torch.cuda.synchronize()
        K.reset_counters()
        t0 = time.perf_counter()
        got = svc.rank(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.counters.as_dict()
        spans = {}
        for _run, j, stage, s0, s1 in svc.pipeline.trace:
            spans.setdefault(j, {})[stage] = (s0, s1)
        per_batch = [max(r.iters for r in got[8 * b:8 * b + 8])
                     for b in range(3)]
        # one graph launch and one host read per batch: K1 and the
        # epilogue run twice per sweep and twice for the certificate
        want_k1 = sum(2 * (s + 1) for s in per_batch)
        check(counts["bsr_converge"] == 3 and counts["host_syncs"] == 3
              and counts["bsr_spmm"] == want_k1
              and counts["sweep_epilogue"] == want_k1,
              f"{label}: sweeps per batch {per_batch} ran as {counts}, not "
              f"one K2 graph per batch with {want_k1} K1 launches")
        print(f"[main {label}] 3 batches x 8 queries in {wall * 1e3:.1f} ms "
              f"({24 / wall:.1f} queries/s); sweeps per batch {per_batch}; "
              f"counters {counts}")
        for j in sorted(spans):
            sp = spans[j]
            print(f"[main {label}] batch {j} latency "
                  f"{(sp['publish'][1] - sp['assemble'][0]) * 1e3:.2f} ms; "
                  "stage ms " + " ".join(
                      f"{k}={(sp[k][1] - sp[k][0]) * 1e3:.2f}"
                      for k in ("assemble", "plan", "sweep", "publish")))
        # every query against the same service on the CPU: the kernels and
        # the plain versions sum f64 in different orders (~1e-16 apart) and
        # the ladder's bf16 phase sums in f64 before rounding, so iters
        # match exactly and scores to 1e-10 L1
        cpu = RankService(g, RankServiceConfig(device="cpu", **cfg, **extra))
        want = cpu.rank(queries)
        worst = 0.0
        for i, (r, o) in enumerate(zip(got, want)):
            l1 = max(np.abs(r.authority - o.authority).sum(),
                     np.abs(r.hub - o.hub).sum())
            worst = max(worst, l1)
            check(np.isfinite(r.authority).all() and r.status == o.status
                  and r.iters == o.iters and l1 <= 1e-10,
                  f"{label} query {i}: cuda iters={r.iters} {r.status} vs "
                  f"cpu iters={o.iters} {o.status}, L1 {l1:.3e}")
        print(f"[main {label}] matches the CPU service: max L1 {worst:.2e}, "
              f"iters equal", flush=True)
        return svc, counts, wall

    svc, counts, wall = serve({}, "f64")
    # device busy share of the same run on a fresh service, from the
    # profiler's device times (tracing slows the host a little, so the idle
    # share it implies is an upper bound)
    fresh = RankService(g, RankServiceConfig(device="cuda", **cfg))
    torch.cuda.synchronize()
    K.reset_counters()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fresh.rank(queries)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    counted = {"bsr_spmm": K.counters.bsr_spmm,
               "sweep_epilogue": K.counters.sweep_epilogue}
    seen = dict.fromkeys(counted, 0)
    dev_us = {}
    for e in prof.key_averages():
        if "bsr_spmm_kernel" in e.key:
            seen["bsr_spmm"] += e.count
        elif "ep_slice_kernel" in e.key or "ep_finish_kernel" in e.key:
            seen["sweep_epilogue"] += e.count
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            dev_us[e.key] = t
    # busy: each kernel and copy once, as a device event (summing every
    # key's self device time counts an aten op's copies twice)
    split = device_split(prof)
    busy = split["all"]
    if busy:
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        print(f"[main f64 profile] device busy {busy:.2f} ms of "
              f"{wall_prof * 1e3:.1f} ms wall (idle share "
              f"{1 - busy / (wall_prof * 1e3):.3f}; every key's self device "
              f"time, the formula of PRs 14-16, gives {split['key_sum']:.2f} "
              f"ms); by key's self device time: "
              + "; ".join(f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top))
    else:
        print("[main f64 profile] the profiler reported no device time: "
              "device busy share not measured")
    # the counts the kernels kept on the device against the kernel
    # instances the profiler saw on the card
    check(seen == counted and counted["bsr_spmm"] > 0,
          f"main path: the profiler saw {seen} kernels, the counters say "
          f"{counted}")
    print(f"[main f64 profile] kernels seen by the profiler {seen} = the "
          f"device-kept counts", flush=True)
    K.reset_counters()
    again = svc.rank(queries[:8])
    check(all(r.status == "hit" for r in again) and
          K.counters.bsr_spmm == 0, "repeat batch was not served from cache")
    print("[main f64] repeat batch: 8/8 cache hits, no kernel launched")
    serve({"rank_k": 10}, "rank_k=10")
    serve({"sweep_dtype": "bf16"}, "bf16 ladder")

    # ------------------------------------------- 3b. live edge deltas
    def delta_counts(svc):
        snap = svc.telemetry_snapshot()
        return dict(patched=snap["service.delta.patched"]["bsr"],
                    replanned=snap["service.delta.replanned"],
                    invalidated=snap["service.delta.invalidated"],
                    plan_misses=svc.stats["plan_misses"],
                    plan_hits=svc.stats["plan_hits"])

    def plan_stage_ms(svc):
        """Plan-stage ms per batch of the service's last run."""
        last = max(t[0] for t in svc.pipeline.trace)
        return {j: (t1 - t0) * 1e3 for run, j, stage, t0, t1
                in svc.pipeline.trace if run == last and stage == "plan"}

    pair = {d: RankService(g, RankServiceConfig(device=d, **cfg))
            for d in ("cuda", "cpu")}

    def serve_both(label):
        """The 24 queries on the card and on the CPU: every query equal to
        1e-10 L1 with equal iters and status, equal delta counters."""
        before = delta_counts(pair["cuda"])
        torch.cuda.synchronize()
        K.reset_counters()
        t0 = time.perf_counter()
        got = pair["cuda"].rank(queries)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = K.counters.bsr_spmm
        want = pair["cpu"].rank(queries)
        worst = 0.0
        for i, (r, o) in enumerate(zip(got, want)):
            l1 = max(np.abs(r.authority - o.authority).sum(),
                     np.abs(r.hub - o.hub).sum())
            worst = max(worst, l1)
            check(np.isfinite(r.authority).all() and r.status == o.status
                  and r.iters == o.iters and l1 <= 1e-10,
                  f"delta {label} query {i}: cuda iters={r.iters} "
                  f"{r.status} vs cpu iters={o.iters} {o.status}, "
                  f"L1 {l1:.3e}")
        counts = delta_counts(pair["cuda"])
        check(counts == delta_counts(pair["cpu"]),
              f"delta {label}: counters {counts} vs the CPU service's "
              f"{delta_counts(pair['cpu'])}")
        moved = {k: counts[k] - before[k] for k in counts}
        statuses = {st: sum(r.status == st for r in got)
                    for st in ("hit", "warm", "cold")}
        plan = plan_stage_ms(pair["cuda"])
        print(f"[delta {label}] {wall * 1e3:.1f} ms for 24 queries "
              f"({statuses}); K1 launches {launches}; counters moved "
              f"{moved}; plan stage ms per batch "
              + " ".join(f"{plan[j]:.2f}" for j in sorted(plan))
              + f"; matches the CPU service: max L1 {worst:.2e}, iters "
              "equal", flush=True)
        return moved, got

    serve_both("before")
    union0 = pair["cuda"].extractor.extract_union(
        [pair["cuda"].extractor.extract(pair["cuda"].validate_roots(q))
         for q in queries[:8]])
    ug = union0.graph
    rng_d = np.random.default_rng(SEED + 4)
    pick = rng_d.choice(ug.n_edges, max(1, ug.n_edges // 100), replace=False)
    pairs = [(int(union0.nodes[ug.src[i]]), int(union0.nodes[ug.dst[i]]))
             for i in pick]
    # a probe service with the same graph and deltas: the patch and a cold
    # plan of the first batch's union, timed directly
    probe_d = RankService(g, RankServiceConfig(device="cuda", **cfg))
    be = BsrSweepBackend(bs=128, device="cuda")
    job0 = PipelineJob(queries=[probe_d.validate_roots(q)
                                for q in queries[:8]], refresh=True)
    pre = probe_d.pipeline.assemble(job0).batch

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    plan_pre, cold_pre_ms = timed(lambda: be.plan(pre))
    summ = {d: pair[d].apply_edge_delta(reweights=[(a, b, 2.0)
                                                   for a, b in pairs])
            for d in pair}
    probe_d.apply_edge_delta(reweights=[(a, b, 2.0) for a, b in pairs])
    check(summ["cuda"]["invalidated"] == summ["cpu"]["invalidated"]
          and not summ["cuda"]["structural"],
          f"weight delta summaries differ: {summ}")
    post = probe_d.pipeline.assemble(job0).batch
    patched, patch_ms = timed(lambda: be.patch(plan_pre, post))
    fresh, cold_post_ms = timed(lambda: be.plan(post))
    check(patched is not None and all(
        torch.equal(getattr(patched, o).blocks, getattr(fresh, o).blocks)
        for o in ("lt", "lfwd")), "the patched plan's blocks differ from "
          "a fresh plan's")
    print(f"[delta weights] {len(pairs)} of the first union's {ug.n_edges} "
          f"edges reweighted by 2.0; swap {summ['cuda']['swap_ms']:.2f} ms, "
          f"{summ['cuda']['invalidated']} cached results invalidated; "
          f"first union: patch_ms={patch_ms:.2f} vs cold plan_ms "
          f"{cold_pre_ms:.2f} (before) {cold_post_ms:.2f} (after)",
          flush=True)
    moved, got = serve_both("after weights")
    check(moved["patched"] >= 1, f"no bsr plan was patched: {moved}")
    check(moved["replanned"] == 0, f"a patchable plan was rebuilt: {moved}")
    # a batch whose 8 queries were all invalidated has its old union (the
    # same topology): patched or, where no edge of it changed, a plan hit,
    # never a cold plan; only a batch with some cache hits has a new union
    hits = [sum(r.status == "hit" for r in got[8 * b:8 * b + 8])
            for b in range(3)]
    partial = sum(0 < h < 8 for h in hits)
    check(moved["plan_misses"] == partial,
          f"{moved['plan_misses']} cold plans for {partial} batches with a "
          f"new union (cache hits per batch {hits})")
    # structural: remove 3 of the first union's edges, add 3 new ones
    existing = set(zip(g.src.tolist(), g.dst.tolist()))
    removes = pairs[-3:]
    adds = []
    while len(adds) < 3:
        a, b = (int(x) for x in rng_d.choice(union0.nodes, 2,
                                             replace=False))
        if (a, b) not in existing and (a, b) not in adds:
            adds.append((a, b))
    summ = {d: pair[d].apply_edge_delta(adds=adds, removes=removes)
            for d in pair}
    check(summ["cuda"]["structural"] and summ["cuda"]["invalidated"]
          == summ["cpu"]["invalidated"], f"structural summaries {summ}")
    print(f"[delta structural] removes {removes} adds {adds}; swap "
          f"{summ['cuda']['swap_ms']:.2f} ms, {summ['cuda']['invalidated']} "
          "cached results invalidated", flush=True)
    serve_both("after adds/removes")

    # ------------------------------------------- 3c. whole-graph HITS
    for name, fn in (("accel_hits", accel_hits), ("qi_hits", qi_hits)):
        r, t_card = timed(lambda: fn(g, tol=1e-10, device="cuda"))
        t0 = time.perf_counter()
        o = fn(g, tol=1e-10, device="cpu")
        t_cpu = (time.perf_counter() - t0) * 1e3
        l1 = max(np.abs(r.v - o.v).sum(), np.abs(r.aux - o.aux).sum())
        check(r.converged and r.iters == o.iters and l1 <= 1e-10
              and np.isfinite(r.v).all() and r.v.shape == (g.n_nodes,),
              f"{name}: card iters={r.iters} converged={r.converged} vs "
              f"cpu iters={o.iters}, L1 {l1:.3e}")
        print(f"[{name}] britannica f64 tol 1e-10: {r.iters} sweeps, "
              f"{t_card:.1f} ms wall on the card (EdgeList build "
              f"included), {t_cpu:.1f} ms on the host CPU; matches the CPU "
              f"run: L1 {l1:.2e}, iters equal", flush=True)

    # ------------------------------------------- 3d. serving periphery
    periphery(g, queries, cfg, timed)

    # ------------------------------------- 3e. the offline ranking path
    whole = offline(g, card, ms, device_ms, timed)
    links = link_form_phase(card)

    # ------------------------------ 3f. the sharded backend (sparse.dist)
    sharded_phase(g, queries, card)

    # ------------------- 3g. the example ports and the recsys family
    train_ms = recsys_phase()

    # ----------------------------------------------- 3h. the LM family
    lm_phase()

    # ----------------------------------------------- 3i. the GNN family
    gnn = gnn_phase()

    # ------------------------------- 3j. the dry-run and roofline tools
    dryrun_phase({"gin-tu": gnn["step_ms"], "dlrm-rm2": train_ms["dlrm-rm2"]})

    # ---------------------------------------------------- 4. result lines
    kernels = [
        dict(name="bsr_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:44",
             launches=counts["bsr_spmm"], max_abs_err=k1["float64"]["err"],
             ms=k1["float64"]["ms"], plain_ms=k1["float64"]["plain_ms"],
             bound_ms=k1["float64"]["bound_ms"],
             bound_by=k1["float64"]["bound_by"],
             library_ms=k1["float64"]["library_ms"],
             hits_sweep_bsr=whole),
        dict(name="links_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:44 on the whole-crawl "
                      "sweep (src/repro/kernels/ops.py::hits_sweep_bsr)",
             launches=sum(c["launches"] for c in links.values()),
             max_abs_err=max(c[t]["max_abs_err"] for c in links.values()
                             for t in ("lt", "l")),
             ms=links["britannica-bb"]["lt"]["ms"],
             plain_ms=links["britannica-bb"]["lt"]["plain_ms"],
             bound_ms=links["britannica-bb"]["bound_ms"], bound_by="bytes",
             library_ms=links["britannica-bb"]["lt"]["library_ms"],
             cells=links),
        dict(name="sweep_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:179",
             launches=counts["sweep_epilogue"], max_abs_err=ep[0]["err"],
             ms=ep[0]["ms"], ms_rank_k10=ep[10]["ms"],
             plain_ms=ep[0]["plain_ms"], bound_ms=ep[0]["bound_ms"],
             bound_by="bytes", library_ms=None),
        dict(name="bsr_converge_cols", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:117",
             launches=counts["bsr_converge"],
             max_abs_err=max(e["err"] for e in k2.values()),
             ms=k2[(0, None)]["call_ms"],
             device_ms=k2[(0, None)]["device_ms"],
             build_ms=k2[(0, None)]["build_ms"],
             plain_ms=k2[(0, None)]["plain_ms"],
             bound_ms=k2[(0, None)]["bound_ms"],
             reread_ms=k2[(0, None)]["reread_ms"],
             bound_by=k2[(0, None)]["bound_by"], library_ms=None),
        dict(name="seg_matmul", route="cuda",
             source="src/repro_torch/kernels/csrc/seg_matmul.cu",
             replaces="src/repro/kernels/seg_matmul.py:25",
             launches=k3_launches + gnn["launches"],
             launches_seg_aggregate=k3_launches,
             max_abs_err=max(e["err"] for e in k3.values()),
             ms=k3[(64, "float32")]["ms"],
             plain_ms=k3[(64, "float32")]["plain_ms"],
             bound_ms=k3[(64, "float32")]["bound_ms"],
             bound_by=k3[(64, "float32")]["bound_by"],
             library_ms=k3[(64, "float32")]["library_ms"],
             gnn=dict(shape="ogb_products", launches=gnn["launches"],
                      ms=gnn["ogb"]["ms"], bound_ms=gnn["ogb"]["bound_ms"],
                      library_ms=gnn["ogb"]["library_ms"],
                      gather_ms=gnn["ogb"]["gather_ms"],
                      step_ms=gnn["step_ms"],
                      step_bound_ms=gnn["bound_ms"])),
    ]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def l1(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).sum())


def offline(g, card, ms, device_ms, timed):
    """Phase 3e: the offline ranking path on the card at full scale.

    (a) Table 7: QI-HITS, accelerated HITS and PageRank (f64, tol 1e-9) on
    the eight datasets at scale 1.0, original and back-button graphs: iters
    equal to the JAX package's (``TABLE7_ITERS``), wall ms per run, for
    ``TABLE7_ON_CPU`` the vectors within 1e-10 L1 of the port on the host
    CPU with equal iters; the paper's claims and the cosine and Spearman
    agreement with QI-HITS printed as findings. (b) K1 on the whole
    graph: ``hits_sweep_bsr`` on britannica (f32, bs 128, unpermuted):
    one K1 call bit-equal to its plain version, ``iters + 5`` sweeps
    against the card's ``RankingEngine`` (max abs < 1e-4 on the hub), K1's
    device time per launch beside its bound, the plain version and
    ``torch.sparse_bsr_tensor @``, and one segment-sum sweep
    (``core.hits.hits_sweep``) of the same graph. (c) ``power_method_jit``
    (f64 K1 sweep) against ``power_method``. (d) The engine on the card
    against the CPU, with and without stragglers, and ``python -m
    repro_torch.launch.rank`` with a checkpoint, then ``--resume``.
    Returns K1's whole-graph numbers for the kernels line."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.core import (EdgeList, accel_hits, accel_weights,
                                  back_button, cosine, hits_sweep, pagerank,
                                  power_method, power_method_jit, qi_hits,
                                  spearman)
    from repro_torch.core.engine import RankingEngine
    from repro_torch.graph import PAPER_TABLE7, paper_dataset
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.kernels import ops as O
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    # ------------------------------------------------ (a) Table 7
    algos = (("hits", qi_hits), ("accel", accel_hits), ("pr", pagerank))
    table = {}
    for name in PAPER_TABLE7:
        g0 = paper_dataset(name, 1.0)
        for tag, gg in (("orig", g0), ("bb", back_button(g0))):
            row, walls, cpu_l1 = {}, [], []
            for algo, fn in algos:
                r, wall = timed(lambda: fn(gg, tol=1e-9, device="cuda"))
                check(r.converged and r.v.shape == (gg.n_nodes,)
                      and np.isfinite(r.v).all() and np.isfinite(r.aux).all(),
                      f"table7 {name} {tag} {algo}: converged={r.converged}"
                      f" after {r.iters} sweeps, or a bad vector")
                if name in TABLE7_ON_CPU:
                    o = fn(gg, tol=1e-9, device="cpu")
                    d = max(l1(r.v, o.v), l1(r.aux, o.aux))
                    check(r.iters == o.iters and d <= 1e-10,
                          f"table7 {name} {tag} {algo}: card iters "
                          f"{r.iters} vs cpu {o.iters}, L1 {d:.3e}")
                    cpu_l1.append(d)
                row[algo] = r
                walls.append(wall)
            iters = tuple(row[a].iters for a, _ in algos)
            check(iters == TABLE7_ITERS[name, tag],
                  f"table7 {name} {tag}: iters hits/accel/pr {iters}, the "
                  f"JAX package's {TABLE7_ITERS[name, tag]}")
            table[name, tag] = row
            print(f"[table7 {name} {tag}] N={gg.n_nodes} E={gg.n_edges} "
                  f"dangling={gg.dangling_fraction():.3f} iters hits/accel/pr="
                  f"{iters} (= the JAX package's) wall ms hits/accel/pr="
                  + "/".join(f"{w:.1f}" for w in walls)
                  + (f"; the host CPU's vectors: max L1 {max(cpu_l1):.2e}, "
                     "iters equal" if cpu_l1 else ""), flush=True)
    wins = [n for n in PAPER_TABLE7 if table[n, "orig"]["accel"].iters
            <= table[n, "orig"]["hits"].iters]
    bb_wins = [n for n in PAPER_TABLE7 if table[n, "bb"]["accel"].iters
               <= min(table[n, "bb"]["hits"].iters,
                      table[n, "bb"]["pr"].iters)]
    print(f"[claims] {card}: accel <= HITS on the original graphs on "
          f"{len(wins)} of 8 (the paper allows one exception: "
          f"{'holds' if len(wins) >= 7 else 'does not hold'}); accel <= "
          f"min(HITS, PageRank) on the back-button graphs on {len(bb_wins)} "
          f"of 8 ({'holds' if len(bb_wins) == 8 else 'does not hold'})")
    for n in PAPER_TABLE7:
        r = table[n, "orig"]
        a, h = r["accel"], r["hits"]
        print(f"[claims {n}] accel vs QI-HITS: authority cosine "
              f"{cosine(a.aux, h.aux):.4f} spearman "
              f"{spearman(a.aux, h.aux):.4f}; hub cosine "
              f"{cosine(a.v, h.v):.4f} spearman {spearman(a.v, h.v):.4f}")
    t_table = time.perf_counter() - t_phase

    # ---------------------------------- (b) K1 over the whole graph
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    t0 = time.perf_counter()
    lt = O.DeviceBSR.build(g, 128, transpose=True, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    nb = lt.blocks.shape[0]
    per_row = np.diff(lt.row_ptr.cpu().numpy())
    edges_per_block = g.n_edges / nb
    x = O._rows(torch.full((g.n_nodes, 1), 1.0 / g.n_nodes,
                           dtype=torch.float32, device=dev), lt.n_pad)
    cin = O._rows(torch.tensor(ch, dtype=torch.float32, device=dev)[:, None],
                  lt.n_pad).contiguous()
    scr = K.Scratch(dev)
    y = K.bsr_scaled_matvec(*lt.operand, x, cin, bs=128, scratch=scr)
    yp = K.bsr_scaled_matvec_plain(*lt.operand, x, cin, bs=128)
    torch.cuda.synchronize()
    err = (y - yp).abs().max().item()
    check(torch.equal(y, yp) and not scr.cnt.any(),
          f"K1 whole graph: max|y - plain| = {err:.3e} (bit-equal wanted), "
          f"or the fold counters are not 0")
    t_k1 = device_ms(lambda: K.bsr_scaled_matvec(*lt.operand, x, cin, bs=128,
                                                 scratch=scr),
                     10, "bsr_spmm_kernel")
    t_plain = ms(lambda: K.bsr_scaled_matvec_plain(*lt.operand, x, cin,
                                                   bs=128), 2)
    moved = nbytes(*lt.operand, x, cin, y)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * nb * 128 * 128 / PEAK_FLOPS["float32"] * 1e3
    xs = x * cin
    mat = torch.sparse_bsr_tensor(lt.row_ptr.long(), lt.idx[:, 1].long(),
                                  lt.blocks, size=(lt.n_pad, lt.n_pad))
    try:
        mat @ xs
        t_lib = device_ms(lambda: mat @ xs, 5)
        lib_kind = "torch.sparse_bsr_tensor @ dense, device"
    except (RuntimeError, NotImplementedError) as e:
        t_lib = None
        lib_kind = f"unavailable: {str(e).splitlines()[0]}"
    del mat, xs
    print(f"[K1 whole graph] {card}: britannica N={g.n_nodes} unpermuted, "
          f"bs 128, f32, V 1: Lt {nb} blocks (of {len(per_row)}^2 = "
          f"{len(per_row) ** 2}; {edges_per_block:.1f} edges a block; "
          f"{per_row.min()}-{per_row.max()} per block row), built in "
          f"{build_s:.2f} s; one call bit-equal to the plain version; "
          f"ms={t_k1:.4f} (device, per launch) bound_ms="
          f"{max(t_bytes, t_ops):.4f} ({moved / 1e9:.3f} GB at 3.35 TB/s) "
          f"-> {moved / (t_k1 * 1e-3) / 1e12:.2f} TB/s; plain_ms="
          f"{t_plain:.2f} library_ms="
          + (f"{t_lib:.4f}" if t_lib is not None else "null")
          + f" ({lib_kind})", flush=True)
    del lt, y, yp, scr
    torch.cuda.empty_cache()

    # the whole-graph sweep, on K1's link form
    sweep, lt, lf = O.hits_sweep_bsr(g, ca, ch, bs=128, device="cuda")
    eng, eng_ms = timed(lambda: RankingEngine(g, "accel", n_shards=8,
                                              device="cuda").run(tol=1e-10))
    check(eng.converged, f"engine: not converged after {eng.iters} sweeps")
    h = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float32,
                   device=dev)
    K.reset_counters()
    t0 = time.perf_counter()
    for _ in range(eng.iters + 5):
        h, _ = sweep(h)
    torch.cuda.synchronize()
    sweeps_ms = (time.perf_counter() - t0) * 1e3
    launches = K.counters.k1_links
    check(launches == 2 * (eng.iters + 5) and K.counters.bsr_spmm == 0,
          f"hits_sweep_bsr: {launches} link-form and "
          f"{K.counters.bsr_spmm} blocked K1 launches for {eng.iters + 5} "
          "sweeps, not 2 and 0 a sweep")
    hub_err = float(np.abs(h.double().cpu().numpy() - eng.hub).max())
    check(hub_err < 1e-4, f"hits_sweep_bsr: hub max abs {hub_err:.3e} from "
          "the engine's")
    h1 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float32,
                    device=dev)
    t_sweep = ms(lambda: sweep(h1), 10)
    t_sweep_dev = device_ms(lambda: sweep(h1), 10)
    # the same graph's segment-sum sweep (core.hits.hits_sweep), f32
    edges = EdgeList.from_graph(g, dev)
    ca32, ch32 = (torch.tensor(c, dtype=torch.float32, device=dev)
                  for c in (ca, ch))
    seg_sweep = hits_sweep(edges, ca=ca32, ch=ch32)
    t_seg = ms(lambda: seg_sweep(h1), 20)
    t_seg_dev = device_ms(lambda: seg_sweep(h1), 20)
    seg_bytes = nbytes(edges.by_dst.gather, edges.by_dst.lengths,
                       edges.by_src.gather, edges.by_src.lengths,
                       ca32, ch32) + 4 * nbytes(h1)
    whole = dict(launches=launches, max_abs_err=err, ms=t_k1,
                 plain_ms=t_plain, bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations",
                 library_ms=t_lib, blocks=nb, sweep_ms=t_sweep,
                 sweep_device_ms=t_sweep_dev, seg_sweep_ms=t_seg,
                 seg_sweep_device_ms=t_seg_dev)
    print(f"[hits_sweep_bsr] {card}: {eng.iters + 5} sweeps ({launches} "
          f"link-form K1 launches) in {sweeps_ms:.1f} ms; hub max abs "
          f"{hub_err:.2e} from the engine's ({eng.iters} sweeps, "
          f"{eng_ms:.1f} ms on the card); one sweep {t_sweep:.3f} ms "
          f"(events; device {t_sweep_dev:.3f} ms) vs the segment-sum sweep "
          f"hits_sweep {t_seg:.3f} ms (events; device {t_seg_dev:.3f} ms, "
          f"{seg_bytes / 1e6:.1f} MB of index and vectors against "
          f"{(lt.nbytes + lf.nbytes) / 1e6:.1f} MB of "
          "links)", flush=True)
    del sweep, lt, lf, edges, seg_sweep
    torch.cuda.empty_cache()

    # ------------------------------------------ (c) power_method_jit
    sw64, _, _ = O.hits_sweep_bsr(g, ca, ch, bs=128, dtype="float64",
                                  device="cuda")
    h64 = torch.full((g.n_nodes,), 1.0 / g.n_nodes, dtype=torch.float64,
                     device=dev)
    for ce in (1, 4):
        host, host_ms = timed(lambda: power_method(sw64, h64, tol=1e-10,
                                                   check_every=ce))
        (v, aux, it, delta), jit_ms = timed(lambda: power_method_jit(
            sw64, h64, tol=1e-10, check_every=ce))
        dv, da = l1(v.cpu(), host.v), l1(aux.cpu(), host.aux)
        if ce == 1:
            check(int(it) == host.iters and dv <= 1e-10 and da <= 1e-10
                  and float(delta) <= 1e-10,
                  f"power_method_jit: iters {int(it)} vs host {host.iters},"
                  f" L1 v {dv:.3e} aux {da:.3e}, delta {float(delta):.3e}")
        print(f"[power_method_jit check_every={ce}] {card}: f64 K1 sweep on "
              f"britannica: {int(it)} sweeps (host loop {host.iters}), "
              f"delta {float(delta):.3e}, L1 v {dv:.2e} aux {da:.2e}; "
              f"{jit_ms:.1f} ms (one graph: capture, build, launch, wait) vs "
              f"the host loop {host_ms:.1f} ms", flush=True)
    del sw64
    torch.cuda.empty_cache()

    # -------------------------------------- (d) engine and launcher
    for kw in ({}, {"straggler_prob": 0.3, "stale_limit": 2}):
        r, t_card = timed(lambda: RankingEngine(g, "accel", n_shards=8,
                                                device="cuda", **kw)
                          .run(tol=1e-10))
        t0 = time.perf_counter()
        o = RankingEngine(g, "accel", n_shards=8, device="cpu",
                          **kw).run(tol=1e-10)
        t_cpu = (time.perf_counter() - t0) * 1e3
        d = max(l1(r.hub, o.hub), l1(r.authority, o.authority))
        check(r.converged and r.iters == o.iters and d <= 1e-10
              and r.stale_events == o.stale_events
              and (r.stale_events > 0) == bool(kw),
              f"engine {kw}: card iters {r.iters} stale {r.stale_events} vs "
              f"cpu iters {o.iters} stale {o.stale_events}, L1 {d:.3e}")
        print(f"[engine {kw or 'no stragglers'}] {card}: 8 shards, "
              f"{r.iters} sweeps, {r.stale_events} stale events (= the CPU "
              f"engine's); {t_card:.1f} ms on the card, {t_cpu:.1f} ms on "
              f"the host CPU; L1 {d:.2e}", flush=True)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_rank_"))
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        base = [sys.executable, "-m", "repro_torch.launch.rank",
                "--dataset", "britannica", "--scale", "1.0", "--backbutton",
                "--ckpt", str(tmp / "ckpt"), "--ckpt-every", "2"]
        outs = []
        for extra in ([], ["--resume"]):
            t0 = time.perf_counter()
            r = subprocess.run(base + extra, capture_output=True, text=True,
                               env=env, cwd=ROOT, timeout=600)
            check(r.returncode == 0, f"launch.rank {extra} exited "
                  f"{r.returncode}: {r.stderr[-2000:]}")
            lines = r.stdout.splitlines()
            res = [x for x in lines if x.startswith("accel:")]
            top = [x for x in lines if x.startswith("top authorities:")]
            check(bool(res) and "converged=True" in res[0] and bool(top),
                  f"launch.rank {extra}: {r.stdout[-1500:]}")
            pages = [t["page"] for t in json.loads(top[0].split(":", 1)[1])]
            outs.append((res[0], int(res[0].split("iters=")[1].split()[0]),
                         pages, time.perf_counter() - t0))
        steps = sorted(p.name for p in (tmp / "ckpt").iterdir())
        check(bool(steps), "launch.rank wrote no checkpoint")
        # the resumed run restarts after the last checkpoint (every 2nd
        # sweep): one sweep more where that was the converged sweep itself
        k = outs[0][1]
        want = k + 1 if k % 2 == 0 else k
        check(outs[1][1] == want and outs[1][2] == outs[0][2],
              f"launch.rank --resume: {outs[1][0]} (want iters={want}) vs "
              f"{outs[0][0]}, top {outs[1][2]} vs {outs[0][2]}")
        print(f"[launch.rank] britannica --backbutton on the card: "
              f"{outs[0][0]} ({outs[0][3]:.1f} s in all); checkpoints "
              f"{steps}; --resume from the last: {outs[1][0]} "
              f"({outs[1][3]:.1f} s), the same top authorities", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[offline] phase 3e: {time.perf_counter() - t_phase:.1f} s "
          f"(Table 7 {t_table:.1f} s)", flush=True)
    return whole


LINK_CELLS = ("britannica-bb", "yahoo-bb")  # rankbench's whole-crawl crawls
LINK_SEED = 2147830419


def link_form_phase(card=""):
    """Phase 3e (e): K1's link form at the whole-crawl cells' shapes (the
    crawls of ``rankbench/configs``, f64, V 1, Ca/Ch from the degrees), on
    both operators of ``hits_sweep_bsr``: bit for bit its plain version
    (run on the host CPU), twice; the kernel's
    device ms a launch beside its bound (``rankbench.roofline``'s bytes
    for one product, half a sweep's, over 3.35 TB/s), the plain version's
    ms (events, on the card's tensors) and ``torch.sparse_csr_tensor @``
    (device, the library yardstick, which the port never calls); one
    ranking to tol 1e-9 counting 2 link-form launches a sweep and no
    blocked K1. Returns {cell: numbers} for the kernels line. Alone:
    ``PYTHONPATH=src python -c "import sys; sys.path.insert(0, '.');
    import chip_smoke as c; c.link_form_phase()"``."""
    import torch
    sys.path.insert(0, str(ROOT))
    from rankbench import roofline, webgraph
    from repro_torch.core import accel_weights, power_method
    from repro_torch.graph.structure import Graph
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.kernels import ops as O
    dev = torch.device("cuda", 0)
    f64 = dict(dtype=torch.float64, device=dev)
    out = {}
    for name in LINK_CELLS:
        cfg = json.loads((ROOT / "rankbench" / "configs"
                          / f"{name}.json").read_text())
        n, src, dst = webgraph.crawl(cfg, LINK_SEED)
        g = Graph(n, src, dst)
        ca, ch = accel_weights(g.indeg(), g.outdeg())
        t0 = time.perf_counter()
        sweep, lt, lf = O.hits_sweep_bsr(g, ca, ch, dtype="float64",
                                         device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        x = torch.full((n, 1), 1.0 / n, **f64)
        bound = roofline.sweep_bytes(n, g.n_edges) / 2 \
            / HBM_BYTES_PER_S * 1e3
        row = dict(pages=n, links=g.n_edges, build_s=build_s,
                   bound_ms=bound, bound_by="bytes")
        for tag, op, c in (("lt", lt, ch), ("l", lf, ca)):
            cin = torch.tensor(c, **f64)[:, None].contiguous()
            y = K.links_scaled_matvec(op, x, cin)
            y2 = K.links_scaled_matvec(op, x, cin)
            yp = K.links_scaled_matvec_plain(
                K.LinkOperand(op.ptr.cpu(), op.cols.cpu(),
                              op.long_rows.cpu(), op.lanes),
                x.cpu(), cin.cpu()).to(dev)
            err = float((y - yp).abs().max())
            check(torch.equal(y, y2) and torch.equal(y, yp),
                  f"K1 link form {name} {tag}: two launches differ, or "
                  f"max|y - plain| {err:.3e} (bit-equal wanted)")
            t_dev = device_ms(lambda: K.links_scaled_matvec(op, x, cin), 20,
                              "links_spmm_kernel")
            t_plain = ms(lambda: K.links_scaled_matvec_plain(op, x, cin), 5)
            mat = torch.sparse_csr_tensor(
                op.ptr.long(), op.cols.long(),
                torch.ones(op.cols.numel(), **f64), size=(n, n))
            xs = x * cin
            t_lib = device_ms(lambda: mat @ xs, 20)
            del mat, xs
            row[tag] = dict(ms=t_dev, plain_ms=t_plain, library_ms=t_lib,
                            max_abs_err=err, lanes=op.lanes,
                            long_rows=op.long_rows.numel())
            print(f"[K1 link form {name} {tag}] {card}: N={n} links="
                  f"{g.n_edges} lanes={op.lanes} long rows="
                  f"{op.long_rows.numel()}: ms={t_dev:.4f} (device, a "
                  f"launch) bound_ms={bound:.4f} (bytes) plain_ms="
                  f"{t_plain:.4f} library_ms={t_lib:.4f} "
                  "(torch.sparse_csr_tensor @ dense, device); bit-equal "
                  "to the plain version, twice", flush=True)
        K.reset_counters()
        r = power_method(sweep, torch.full((n,), 1.0 / n, **f64), tol=1e-9,
                         max_iter=2000)
        launches = K.counters.k1_links
        check(r.converged and launches == 2 * r.iters
              and K.counters.bsr_spmm == 0,
              f"K1 link form {name}: {launches} link-form and "
              f"{K.counters.bsr_spmm} blocked launches for {r.iters} sweeps")
        row.update(launches=launches, sweeps=r.iters,
                   operator_bytes=lt.nbytes + lf.nbytes)
        print(f"[K1 link form {name}] a ranking to 1e-9: {r.iters} sweeps, "
              f"{launches} link-form launches, no blocked K1; "
              f"{row['operator_bytes']} B of operators a sweep; built in "
              f"{build_s:.2f} s", flush=True)
        out[name] = row
        del sweep, lt, lf
        torch.cuda.empty_cache()
    return out


def served_l1(a, b):
    return max(np.abs(a.authority - b.authority).sum(),
               np.abs(a.hub - b.hub).sum())


def periphery(g, queries, cfg, timed):
    """Phase 3d: the queued frontend, the restart spill and the launcher
    on britannica at the main path's configuration. Any failed check
    exits non-zero; temporary spill dirs go at the end."""
    import shutil
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_spill_"))
    try:
        queued_phase(g, cfg)
        spill_phase(g, queries, cfg, timed, tmp)
        launcher_phase(g, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def queued_phase(g, cfg):
    """(a) A Zipf stream (seed 0, 48 requests of 50 roots) submitted one
    at a time through ``svc.queue(deadline_ms=5)`` with Poisson arrivals,
    a quarter of them best effort, each with an SLA. Every served query
    is held to a cold CPU ranking of its root set: <= 1e-10 L1 on
    authority and hub, iters not compared (a batch's make-up, and so a
    column's warm or cold start, depends on arrival timing). Class 0 sheds
    nothing; K2 runs one graph and one host read per swept batch, with
    2 x (sweeps + 1) K1 and epilogue launches."""
    import torch
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.launch.serve_rank import zipf_query_stream
    from repro_torch.serve import RankService, RankServiceConfig
    rng = np.random.default_rng(SEED)
    stream = zipf_query_stream(rng, g.n_nodes, 48, 50)
    gaps = rng.exponential(1.0 / 200.0, len(stream))  # 200 q/s offered
    pris = (rng.uniform(size=len(stream)) < 0.25).astype(int)
    sla_ms = 2000.0
    svc = RankService(g, RankServiceConfig(device="cuda", **cfg))
    torch.cuda.synchronize()
    K.reset_counters()
    q = svc.queue(deadline_ms=5)
    t0 = time.perf_counter()
    try:
        tickets = []
        for roots, gap, pri in zip(stream, gaps, pris):
            time.sleep(gap)
            tickets.append(q.submit(roots, priority=int(pri),
                                    deadline_ms=sla_ms))
        got = [t.result(timeout=300) for t in tickets]
        wall = time.perf_counter() - t0
    finally:
        q.close(wait=False)
        q._thread.join(timeout=300)
    check(not q._thread.is_alive(), "queued: the dispatcher did not stop")
    q.flush()
    counts = K.counters.as_dict()
    swept, sweeps = svc.pipeline.stats["swept"], svc.stats["sweeps"]
    want_k1 = 2 * (sweeps + swept)
    check(counts["bsr_converge"] == counts["host_syncs"] == swept >= 1
          and counts["bsr_spmm"] == counts["sweep_epilogue"] == want_k1,
          f"queued: {swept} swept batches of {sweeps} sweeps ran as "
          f"{counts}, not one K2 graph per batch with {want_k1} K1 launches")
    qs = q.snapshot_stats()
    cls = qs["classes"]
    check(cls.get(0, {}).get("shed", 0) == 0, f"queued: class 0 shed {cls}")
    # every served root set against a cold CPU ranking of it (warm starts
    # off), one column each
    served = [(r, x) for r, x in zip(got, stream) if r.status != "shed"]
    distinct = {}
    for r, x in served:
        distinct.setdefault(r.key, x)
    cpu = RankService(g, RankServiceConfig(device="cpu", warm_min_overlap=2.0,
                                           **cfg))
    want = dict(zip(distinct, cpu.rank(list(distinct.values()))))
    worst = 0.0
    for r, x in served:
        o = want[r.key]
        l1 = served_l1(r, o)
        worst = max(worst, l1)
        check(np.array_equal(r.nodes, o.nodes) and np.isfinite(r.authority)
              .all() and l1 <= 1e-10,
              f"queued query {r.key[:12]} ({r.status}): L1 {l1:.3e} against "
              f"the cold CPU ranking")
    statuses = {st: sum(r.status == st for r in got)
                for st in ("hit", "warm", "cold", "shed")}
    print(f"[queued] {len(stream)} requests ({len(distinct)} distinct root "
          f"sets) through svc.queue(deadline_ms=5), Poisson arrivals at 200 "
          f"q/s offered, SLA {sla_ms:.0f} ms, class 1 (best effort) "
          f"{int(pris.sum())}: {wall * 1e3:.1f} ms wall, "
          f"{len(stream) / wall:.1f} q/s; {statuses}; {qs['batches']} "
          f"batches (vmax {qs['flush_vmax']} / deadline "
          f"{qs['flush_deadline']} / close {qs['flush_close']}), "
          f"{qs['coalesced']} coalesced, shed {qs['shed']}, deadline misses "
          f"{qs['deadline_miss']}, degraded {qs['degraded']}; counters "
          f"{counts}", flush=True)
    for pri, c in cls.items():
        print(f"[queued] class {pri}: {c['submitted']} submitted / "
              f"{c['served']} served / {c['shed']} shed, p50 {c['p50_ms']} "
              f"ms p95 {c['p95_ms']} ms")
    print(f"[queued] every served query matches a cold CPU ranking of its "
          f"root set: max L1 {worst:.2e}", flush=True)


def spill_phase(g, queries, cfg, timed, tmp):
    """(b) Restart from the spill: service A (card) serves the main path's
    3 batches and flushes; B on the same dir restores A's entries and
    serves the repeat stream as hits; C finds the plans on disk but not
    the vectors (cleared) and sweeps through restored plans to A's bits.
    A built plan of the first union against a restored one (npz read +
    H2D); then a spill dir the port wrote on the CPU restores on the card
    (a hit, then the plans)."""
    import torch
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.serve import (BsrSweepBackend, PipelineJob, PlanSpill,
                                   RankService, RankServiceConfig)

    def card(d, **kw):
        return RankService(g, RankServiceConfig(
            device="cuda", spill_dir=str(d), **cfg, **kw))

    def plan_ms(svc):
        last = max(t[0] for t in svc.pipeline.trace)
        return [round((t1 - t0) * 1e3, 4) for run, j, stage, t0, t1
                in svc.pipeline.trace if run == last and stage == "plan"]

    a = card(tmp / "card")
    first = a.rank(queries)
    a.flush_spill()
    check(a.stats["plan_spilled"] == a.stats["plan_misses"] == 3,
          f"spill: service A spilled {a.stats['plan_spilled']} of "
          f"{a.stats['plan_misses']} built plans")
    b = card(tmp / "card")
    check(b.stats["spill_restored"] == len(a._cache) == len(queries),
          f"spill: B restored {b.stats['spill_restored']} of A's "
          f"{len(a._cache)} entries")
    hits = b.rank(queries)
    check(all(r.status == "hit" and np.array_equal(r.authority, f.authority)
              for r, f in zip(hits, first)), "spill: B's repeat stream is "
          "not all hits with A's vectors")
    c = card(tmp / "card")
    c.clear_result_cache()  # plans on disk, vectors not
    torch.cuda.synchronize()
    K.reset_counters()
    again = c.rank(queries)
    torch.cuda.synchronize()
    counts = K.counters.as_dict()
    check(c.stats["plan_restored"] == 3 and c.stats["plan_misses"] == 0,
          f"spill: C restored {c.stats['plan_restored']} plans, built "
          f"{c.stats['plan_misses']}")
    check(counts["bsr_converge"] == counts["host_syncs"] == 3,
          f"spill: C's batches ran as {counts}")
    for r, f in zip(again, first):
        check(r.status == f.status and r.iters == f.iters
              and np.array_equal(r.authority, f.authority)
              and np.array_equal(r.hub, f.hub),
              f"spill: a restored plan's result differs from A's "
              f"({r.status} {r.iters} vs {f.status} {f.iters})")
    snap = a.telemetry_snapshot()
    print(f"[spill] A: 3 batches, {a.stats['plan_spilled']} plans and "
          f"{a.stats['spill_writes']} vectors spilled, plan stage ms "
          f"(build + write-through) {plan_ms(a)}; spill.write_ms "
          f"{snap['service.spill.write_ms']}; B: restored "
          f"{b.stats['spill_restored']} entries, 24/24 hits; C: vectors "
          f"cleared, {c.stats['plan_restored']} plans restored, 0 built, "
          f"plan stage ms (npz read + H2D) {plan_ms(c)}, results equal to "
          f"A's bit for bit; C spill.read_ms "
          f"{c.telemetry_snapshot()['service.spill.read_ms']}", flush=True)

    # a built plan of the first union against a restored one, timed alone
    probe = RankService(g, RankServiceConfig(device="cuda", **cfg))
    batch = probe.pipeline.assemble(PipelineJob(
        queries=[probe.validate_roots(x) for x in queries[:8]])).batch
    be = BsrSweepBackend(bs=128, device="cuda")
    built_ms, read_ms, h2d_ms = [], [], []
    ps = PlanSpill(str(tmp / "probe"))
    for _ in range(3):
        plan, ms = timed(lambda: be.plan(batch))
        built_ms.append(round(ms, 4))
    ps.put(("probe",), *be.plan_arrays(plan))
    for _ in range(3):
        rec, ms = timed(lambda: ps.get(("probe",)))
        read_ms.append(round(ms, 4))
        back, ms = timed(lambda: be.plan_restore(plan.key, *rec))
        h2d_ms.append(round(ms, 4))
    check(all(torch.equal(getattr(back, o).blocks, getattr(plan, o).blocks)
              for o in ("lt", "lfwd")), "spill: a restored plan's blocks "
          "differ from the built plan's")
    mb = sum(x.nbytes for x in rec[0].values()) / 1e6
    # where the restore's H2D step goes: the host copy ``from_arrays``
    # makes of each block array, and the pageable copies to the card
    blocks = [rec[0]["lt_blocks"], rec[0]["lfwd_blocks"]]
    copies, ms = timed(lambda: [np.array(x, order="C") for x in blocks])
    _, ms_h2d = timed(lambda: [torch.from_numpy(x).to("cuda")
                               for x in copies])
    print(f"[spill] first union, alone: built plan (permutation + to_bsr + "
          f"H2D) ms {built_ms}; restored plan: npz read ms {read_ms} + "
          f"H2D ms {h2d_ms} ({mb:.1f} MB of arrays); of the H2D step, the "
          f"block arrays' host copy {ms:.4f} ms and their pageable copy "
          f"to the card {ms_h2d:.4f} ms", flush=True)

    # cross-package direction that the card can run: the port on the CPU
    # writes, the card restores a vector and the plans
    host = RankService(g, RankServiceConfig(
        device="cpu", spill_dir=str(tmp / "cpu"), **cfg))
    want = host.rank(queries[:8])
    d = card(tmp / "cpu")
    check(d.stats["spill_restored"] == 8, f"spill: the card restored "
          f"{d.stats['spill_restored']} of the CPU's 8 entries")
    hit = d.rank([queries[0]])[0]
    check(hit.status == "hit" and np.array_equal(hit.authority,
                                                 want[0].authority),
          "spill: the CPU-written entry was not served as a hit")
    d.clear_result_cache()
    got = d.rank(queries[:8])
    check(d.stats["plan_restored"] == 1 and d.stats["plan_misses"] == 0,
          f"spill: the card restored {d.stats['plan_restored']} CPU plans")
    worst = max(served_l1(r, o) for r, o in zip(got, want))
    check(worst <= 1e-10 and all(r.iters == o.iters
                                 for r, o in zip(got, want)),
          f"spill: the CPU-written plan swept on the card: L1 {worst:.3e}")
    print(f"[spill] a spill dir the port wrote on the CPU: 8 entries "
          f"restored on the card, a hit equal to the CPU's vector, the plan "
          f"restored and swept on the card: max L1 {worst:.2e} against the "
          f"CPU, iters equal", flush=True)


def launcher_phase(g, tmp):
    """(c) ``python -m repro_torch.launch.serve_rank`` as a subprocess:
    queued frontend on britannica, stats on an ephemeral port, a spill dir
    and a delta file. Probe /healthz, SIGHUP (a 1-edge reweight inside the
    first request's union), SIGTERM: exit 0 with the delta roll, drain and
    SLA lines; then a relaunch on the spill dir restores entries. Every
    wait has a timeout; the subprocess is killed on any failure."""
    import queue as _queue
    import signal
    import threading
    import urllib.request
    from repro_torch.graph import SubgraphExtractor
    from repro_torch.launch.serve_rank import zipf_query_stream
    stream = zipf_query_stream(np.random.default_rng(SEED), g.n_nodes, 1, 50)
    fs = SubgraphExtractor(g, 32, 32).extract(np.unique(stream[0]))
    u, v = int(fs.nodes[fs.graph.src[0]]), int(fs.nodes[fs.graph.dst[0]])
    delta = tmp / "delta.json"
    delta.write_text(json.dumps({"reweights": [[u, v, 2.0]]}))
    spill = tmp / "launcher"
    base = [sys.executable, "-m", "repro_torch.launch.serve_rank",
            "--dataset", "britannica", "--scale", "1.0", "--backend", "bsr",
            "--v", "8", "--roots", "50", "--seed", str(SEED),
            "--spill-dir", str(spill)]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    args = base + ["--requests", "400", "--frontend", "queued",
                   "--arrival-qps", "40", "--deadline-ms", "5",
                   "--low-pri-frac", "0.25", "--sla-ms", "2000",
                   "--stats-port", "0", "--delta-file", str(delta)]
    lines, seen = _queue.Queue(), []
    err = open(tmp / "launcher.err", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen(args, stdout=subprocess.PIPE, stderr=err,
                            text=True, env=env, cwd=ROOT)

    def pump():
        for x in proc.stdout:
            lines.put(x.rstrip("\n"))
        lines.put(None)

    def wait_for(prefix, timeout):
        end = time.monotonic() + timeout
        while True:
            left = end - time.monotonic()
            if left <= 0:
                fail(f"launcher: no '{prefix}' line in {timeout} s; "
                     f"last lines {seen[-8:]}")
            try:
                x = lines.get(timeout=left)
            except _queue.Empty:
                continue
            if x is None:
                fail(f"launcher exited before '{prefix}': {seen[-8:]} "
                     f"{(tmp / 'launcher.err').read_text()[-2000:]}")
            seen.append(x)
            if x.startswith(prefix):
                return x

    def get(port, path):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                        timeout=30) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def served_by(port, n, timeout=120):
        """Wait until the service has served n queries; returns the count."""
        end = time.monotonic() + timeout
        while True:
            got = json.loads(get(port, "/stats.json")[1])["service"][
                "service.queries"]
            if got >= n:
                return got
            if time.monotonic() > end or proc.poll() is not None:
                fail(f"launcher: {got} queries served, waited for {n}")
            time.sleep(0.1)

    threading.Thread(target=pump, daemon=True).start()
    try:
        port = int(wait_for("stats:", 300).rsplit(":", 1)[1])
        wait_for("serving:", 120)
        t_up = time.perf_counter() - t0
        health = get(port, "/healthz")
        check(health == (200, b"ok"), f"launcher: /healthz gave {health}")
        served_before = served_by(port, 8)  # the roll comes mid-stream
        proc.send_signal(signal.SIGHUP)
        roll = wait_for("delta roll:", 120)
        check("admission re-opened" in roll, f"launcher: {roll}")
        stats = json.loads(get(port, "/stats.json")[1])
        served_after = served_by(port, stats["service"]["service.queries"]
                                 + 8)  # and admission is open again
        check(stats["queue"]["queue.drains"] == 1,
              f"launcher: /stats.json counts {stats['queue']['queue.drains']}"
              " drains after the roll")
        proc.send_signal(signal.SIGTERM)
        drain = wait_for("drain:", 120)
        rest, end = [], time.monotonic() + 180
        while True:  # everything up to the process's exit
            check(time.monotonic() < end, f"launcher: still printing after "
                  f"SIGTERM: {rest[-8:]}")
            try:
                x = lines.get(timeout=1)
            except _queue.Empty:
                continue
            if x is None:
                break
            rest.append(x)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        err.close()
    check(rc == 0, f"launcher exited {rc}: "
          f"{(tmp / 'launcher.err').read_text()[-2000:]}")
    sla = [x for x in rest if x.startswith("sla:")]
    classes = [x for x in rest if x.startswith("  class")]
    check(bool(sla) and any(x.startswith("  class 0:") and "/ 0 shed" in x
                            for x in classes),
          f"launcher: no sla line, or class 0 shed something: {rest}")
    print(f"[launcher] up in {t_up:.1f} s (imports, britannica, warm-up "
          f"batch); /healthz 200 ok on port {port}; SIGHUP after "
          f"{served_before} served: {roll}; {served_after} served after it; "
          f"SIGTERM: {drain}; "
          f"{sla[0]}; "
          + "; ".join(x.strip() for x in classes), flush=True)
    for x in rest:
        if x.startswith(("queue:", "served", "cache:", "plans:",
                         "latency:")):
            print(f"[launcher] {x}")
    r = subprocess.run(base + ["--requests", "8"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    check(r.returncode == 0, f"launcher relaunch exited {r.returncode}: "
          f"{r.stderr[-2000:]}")
    restored = [x for x in r.stdout.splitlines()
                if x.startswith("spill: restored")]
    check(bool(restored) and int(restored[0].split()[2]) >= 1,
          f"launcher relaunch restored nothing: {r.stdout[-1500:]}")
    print(f"[launcher] relaunch on the spill dir: {restored[0]}; "
          + "; ".join(x for x in r.stdout.splitlines()
                      if x.startswith(("cache:", "plans:"))), flush=True)


def device_split(prof):
    """Device ms from a profile: every kernel and copy once (the device
    events), and the part launched under each ``dist.*`` range (the
    segment sums and the collectives of ``sparse.dist``)."""
    from torch.autograd import DeviceType
    out = {"all": 0.0}
    # the busy sum of PRs 14-16: every key's self device time, where an aten
    # op's own kernels and copies count again as device events
    out["key_sum"] = sum(getattr(e, "self_device_time_total", 0) or 0
                         for e in prof.key_averages())
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and \
                not getattr(e, "is_user_annotation", False):
            out["all"] += e.time_range.elapsed_us()
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        us = sum(k.duration for k in e.kernels)
        p = e
        while p is not None and not p.name.startswith("dist."):
            p = p.cpu_parent
        if p is not None:
            out[p.name] = out.get(p.name, 0.0) + us
    return {k: v / 1e3 for k, v in out.items()}


def sharded_phase(g, queries, card):
    """Phase 3f: the sharded backend (``sparse.dist``, one process over a
    tuple of devices) at the main path's configuration: the 3 batches
    through ``backend="sharded"`` in both modes at S in {1, 2, 4} shards
    placed round-robin over the visible cards (logical shards where there
    is one card: they check the layout and the arithmetic, not the
    interconnect), every query held to a CPU dense service (1e-10 L1,
    equal nodes, iters and status), the mesh's segment sums at 2 S per
    sweep, a repeat batch served from cache; per batch the plan and sweep
    stage ms; per sweep the host reads (profiler) and the wire bytes
    (mesh counters) beside ``collective_bytes_per_sweep_cols``; from a
    profiled rerun the device time of the segment sums against the
    collectives, and the idle share. Then a weight-only delta (patched,
    never replanned), a sharded plan spilled and restored, and the
    whole-graph ``make_dist_hits_sweep`` on britannica in all three modes
    on a (4, 2) mesh for 60 sweeps against the card's ``accel_hits``."""
    import shutil
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import accel_hits, accel_weights
    from repro_torch.serve import PipelineJob, RankService, RankServiceConfig
    from repro_torch.sparse import dist
    t_phase = time.perf_counter()
    base = dict(v_max=8, dtype="float64", tol=1e-10)
    want = RankService(g, RankServiceConfig(device="cpu", backend="dense",
                                            **base)).rank(queries)

    def held(got, ref, label):
        worst = 0.0
        for i, (r, o) in enumerate(zip(got, ref)):
            d = served_l1(r, o)
            worst = max(worst, d)
            check(np.array_equal(r.nodes, o.nodes) and r.status == o.status
                  and r.iters == o.iters and d <= 1e-10
                  and np.isfinite(r.authority).all()
                  and np.isfinite(r.hub).all(),
                  f"{label} query {i}: card {r.status} iters={r.iters} vs "
                  f"cpu dense {o.status} iters={o.iters}, L1 {d:.3e}")
        return worst

    def stage_ms(svc, stage):
        last = max(t[0] for t in svc.pipeline.trace)
        return [round((t1 - t0) * 1e3, 2) for run, _j, st, t0, t1
                in svc.pipeline.trace if run == last and st == stage]

    def sharded(mode, s, **kw):
        return RankService(g, RankServiceConfig(
            device="cuda", backend="sharded", shard_mode=mode,
            shard_devices=s, **base, **kw))

    def ms_of(fn, n):
        """Mean ms per call of fn over n calls after a warm-up (events)."""
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    def reads_per_sweep(be, batch, n=5):
        """Host reads (``aten::_local_scalar_dense``) per call of the sweep
        body, over n calls on the batch's plan."""
        plan = be.plan(batch)
        h, ca, ch, m = be._vector_layout(plan, batch.h0, batch.ca, batch.ch,
                                         batch.mask, batch.dtype)
        sweep = dist.make_dist_hits_sweep_cols(be.mesh, be.mode, plan.n_pad)
        sweep(h, ca, ch, m, plan.layouts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(n):
                h, _a = sweep(h, ca, ch, m, plan.layouts)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.key == "aten::_local_scalar_dense") / n

    for mode in ("replicated", "dual_blocked"):
        for s in (1, 2, 4):
            label = f"sharded {mode} S={s}"
            svc = sharded(mode, s)
            be = svc._backend_for(0, 0)
            mesh = be.mesh
            check(be.name == "sharded" and mesh.size == s
                  and all(d.type == "cuda" for d in mesh.devices),
                  f"{label}: mesh {mesh}")
            torch.cuda.synchronize()
            mesh.reset_counters()
            t0 = time.perf_counter()
            got = svc.rank(queries)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            per_batch = [max(r.iters for r in got[8 * b:8 * b + 8])
                         for b in range(3)]
            sweeps = sum(n + 1 for n in per_batch)
            worst = held(got, want, label)
            check(mesh.segment_sums == 2 * s * sweeps,
                  f"{label}: {mesh.segment_sums} segment sums for {sweeps} "
                  f"sweeps, not 2 S per sweep")
            run_bytes = dict(mesh.collective_bytes)
            plan_ms, sweep_ms = stage_ms(svc, "plan"), stage_ms(svc, "sweep")
            mesh.reset_counters()
            again = svc.rank(queries[:8])
            check(all(r.status == "hit" for r in again)
                  and mesh.segment_sums == 0,
                  f"{label}: the repeat batch was not served from cache")
            batch = svc.pipeline.assemble(PipelineJob(
                queries=[svc.validate_roots(q) for q in queries[:8]],
                refresh=True)).batch
            n_pad, v = batch.h0.shape
            wire = be.measure_wire_bytes(n_pad, v, batch.src, batch.dst,
                                         batch.w)
            ana = be.collective_bytes_per_sweep(n_pad, v)
            reads = reads_per_sweep(be, batch)
            print(f"[{label}] devices {[str(d) for d in mesh.devices]}; 3 "
                  f"batches in {wall * 1e3:.1f} ms; sweeps per batch "
                  f"{per_batch} (+1 certificate each); plan ms "
                  f"{plan_ms}; sweep ms {sweep_ms}; matches the CPU dense "
                  f"service: max L1 {worst:.2e}, nodes/iters/status equal; "
                  f"repeat batch 8/8 hits", flush=True)
            print(f"[{label}] per sweep: {mesh.size * 2} segment sums, "
                  f"{reads:.1f} host reads in the sweep body (+1 for the "
                  f"loop's stop test); first union n_pad {n_pad} V {v}: "
                  f"wire bytes one sweep {wire:.1f} (mesh counters) vs "
                  f"collective_bytes_per_sweep_cols {ana}; the run's "
                  f"collective output bytes {run_bytes} over {sweeps} "
                  f"sweeps", flush=True)
            # a profiled rerun on a fresh service: device time split
            fresh = sharded(mode, s)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fresh.rank(queries)
                torch.cuda.synchronize()
                wall_prof = (time.perf_counter() - t0) * 1e3
            split = device_split(prof)
            if split["all"]:
                coll = sum(split.get(k, 0.0) for k in
                           ("dist.psum", "dist.all_gather", "dist.ppermute"))
                print(f"[{label} profile] {card}: device busy "
                      f"{split['all']:.2f} ms of {wall_prof:.1f} ms wall "
                      f"(idle share {1 - split['all'] / wall_prof:.3f}); "
                      f"segment sums {split.get('dist.segment_sum', 0.0):.3f}"
                      f" ms, collectives {coll:.3f} ms ("
                      + ", ".join(f"{k[5:]} {x:.3f}" for k, x in
                                  sorted(split.items())
                                  if k.startswith("dist."))
                      + f"); every key's self device time gives "
                      f"{split['key_sum']:.2f} ms", flush=True)
            else:
                print(f"[{label} profile] the profiler reported no device "
                      "time: device split not measured", flush=True)

    # one shard's segment sum with the zero-weight padding in its layout
    # (as the reference's segment_sum adds it) and without (the port's
    # layout): on the card segment_reduce adds a segment serially, and the
    # padding lands in one segment (the dead pad row)
    from repro_torch.runtime import from_host
    from repro_torch.sparse.spmv import segment_layout, segment_sum
    sh = dist.build_edge_shards_cols(batch.src, batch.dst, batch.w, n_pad, 1,
                                     "replicated")
    src, dst = (from_host(sh[k][0]).cuda() for k in ("src", "dst"))
    w = from_host(sh["w"][0]).cuda().double()
    x = torch.rand((n_pad, v), dtype=torch.float64, device="cuda")
    lays = {"with padding": segment_layout(src, dst, n_pad, w),
            "without": dist.live_layout(src, dst, n_pad, w)}
    outs, t = {}, {}
    for name, lay in lays.items():
        outs[name] = segment_sum(x, lay)
        t[name] = ms_of(lambda: segment_sum(x, lay), 20)
    check(torch.equal(outs["with padding"], outs["without"]),
          "segment sum: leaving the zero-weight padding out changed a bit")
    pad = int((w == 0).sum())
    print(f"[sharded segment sum] first union, one shard of {sh['per']} "
          f"edges ({pad} of them zero-weight padding, all at the dead pad "
          f"row), V {v} f64: {t['with padding']:.4f} ms a call with the "
          f"padding in the layout, {t['without']:.4f} ms without (CUDA "
          f"events, launch and host reads included); the sums bit-equal",
          flush=True)

    # a weight-only delta on a 2-shard service: patched, never replanned
    for mode in ("replicated", "dual_blocked"):
        label = f"sharded {mode} S=2 delta"
        svc = sharded(mode, 2)
        cpu = RankService(g, RankServiceConfig(device="cpu", backend="dense",
                                               **base))
        svc.rank(queries[:8])
        cpu.rank(queries[:8])
        fs = svc.extractor.extract(svc.validate_roots(queries[0]))
        pick = np.random.default_rng(4).choice(fs.graph.n_edges, 20,
                                               replace=False)
        rw = [(int(fs.nodes[fs.graph.src[i]]), int(fs.nodes[fs.graph.dst[i]]),
               2.0) for i in pick]
        svc.apply_edge_delta(reweights=rw)
        cpu.apply_edge_delta(reweights=rw)
        got = svc.rank(queries[:8])
        snap = svc.telemetry_snapshot()
        check(snap["service.delta.patched"]["sharded"] >= 1
              and snap["service.delta.replanned"] == 0,
              f"{label}: patched {snap['service.delta.patched']}, "
              f"replanned {snap['service.delta.replanned']}")
        worst = held(got, cpu.rank(queries[:8]), label)
        print(f"[{label}] 20 union edges reweighted: patched "
              f"{snap['service.delta.patched']['sharded']}, replanned 0; "
              f"plan ms {stage_ms(svc, 'plan')}; matches the CPU dense "
              f"service given the same delta: max L1 {worst:.2e}",
              flush=True)

    # a sharded plan spilled and restored
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    try:
        a = sharded("dual_blocked", 2, spill_dir=str(tmp))
        first = a.rank(queries)
        a.flush_spill()
        b = sharded("dual_blocked", 2, spill_dir=str(tmp))
        b.clear_result_cache()
        again = b.rank(queries)
        check(b.stats["plan_restored"] == 3 and b.stats["plan_misses"] == 0,
              f"sharded spill: restored {b.stats['plan_restored']} plans, "
              f"built {b.stats['plan_misses']}")
        worst = held(again, want, "sharded spill")
        for r, f in zip(again, first):
            check(r.iters == f.iters and np.array_equal(r.authority,
                                                        f.authority),
                  "sharded spill: a restored plan's result differs")
        print(f"[sharded spill] dual_blocked S=2: {a.stats['plan_spilled']} "
              f"plans spilled, {b.stats['plan_restored']} restored, 0 built; "
              f"plan ms restored {stage_ms(b, 'plan')} vs built "
              f"{stage_ms(a, 'plan')}; results equal to the first "
              f"service's bit for bit, max L1 to the CPU dense {worst:.2e}",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the whole graph on a (4, 2) mesh of logical shards
    ref = accel_hits(g, tol=1e-12, device="cuda")
    ca, ch = accel_weights(g.indeg(), g.outdeg())
    mesh = dist.make_mesh((4, 2), ("data", "model"), device="cuda")
    for mode in ("replicated", "dual_blocked", "dual_blocked_compact"):
        shards = dist.build_edge_shards(g, 8, mode)
        sweep, h, args = dist.make_dist_hits_sweep(
            mesh, shards, g.n_nodes, ca=ca, ch=ch, dtype="float64")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(60):
            h, _a = sweep(h, *args)
        torch.cuda.synchronize()
        t_sweep = (time.perf_counter() - t0) * 1e3 / 60
        if mode == "replicated":
            hf = h[0].cpu().numpy()
        else:
            n_keep = shards["n_hub"] if mode.endswith("compact") \
                else g.n_nodes
            hf = dist.blocked_to_full(h, n_keep)
            if mode.endswith("compact"):
                full = np.zeros(g.n_nodes)
                full[shards["nd_ids"]] = hf
                hf = full
        err = float(np.abs(hf - ref.v).max())
        check(np.isfinite(hf).all() and err < 1e-12,
              f"dist sweep {mode}: max abs {err:.3e} to accel_hits")
        print(f"[dist whole graph] britannica {mode}, (4, 2) mesh on "
              f"{sorted({str(d) for d in mesh.devices})}: 60 f64 sweeps, "
              f"{t_sweep:.3f} ms a sweep (host clock); max abs "
              f"{err:.2e} to the card's accel_hits ({ref.iters} sweeps)",
              flush=True)
    print(f"[sharded] phase 3f: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


RECSYS_ROWS_CUT = {
    "dlrm-rm2": dict(vocab_per_field=1000),
    "dcn-v2": dict(vocab_per_field=1000),
    "bst": dict(vocab=100_000),
    "two-tower-retrieval": dict(n_users=10_000, n_items=100_000),
}


def recsys_vs_host(arch, kw, dev, b_cmp=512):
    """Phase 3g (b) for one architecture: its full ``CONFIG`` with the
    rows cut to ``kw`` on ``dev`` against the same module on the host CPU
    (see ``recsys_phase``); returns the line to print."""
    import dataclasses

    import torch
    from repro_torch.configs import get_spec
    from repro_torch.launch.train import model_and_data
    from repro_torch.models import recsys as rs
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, to_device,
                                   value_and_grad)
    from repro_torch.tree import leaves

    def rel(a, b):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    cfg = dataclasses.replace(get_spec(arch).config, **kw)
    host, loss_fn, batch_fn = model_and_data(cfg, b_cmp, 0, "cpu")
    models = [model_and_data(cfg, b_cmp, 1, dev)[0].params_from_reference(
        host.to_tree()) for _ in range(2)]
    batch = batch_fn(0)
    bd = to_device(batch, dev)
    if arch == "two-tower-retrieval":
        out_c = rs.retrieval_scores(host, batch["user"], batch["item"])
        out_d = rs.retrieval_scores(models[0], bd["user"], bd["item"])
    elif arch == "bst":
        out_c = host(batch["hist"], batch["target"])
        out_d = models[0](bd["hist"], bd["target"])
    else:
        out_c = host(batch["dense"], batch["sparse"])
        out_d = models[0](bd["dense"], bd["sparse"])
    lc, gc = value_and_grad(loss_fn, host, batch)
    ld, gd = value_and_grad(loss_fn, models[0], bd)
    errs = {"logits": rel(out_d, out_c), "loss": rel(ld, lc),
            "grads": max(rel(a, b) for a, b in zip(leaves(gd),
                                                   leaves(gc)))}
    check(all(e <= 1e-4 for e in errs.values())
          and torch.isfinite(out_d).all(),
          f"{arch}: card vs CPU {errs}")
    top = ""
    if arch == "two-tower-retrieval":
        rng = np.random.default_rng(SEED)
        prior = rng.random(cfg.n_items) + 1e-3
        users = torch.arange(4)
        cands = torch.arange(cfg.n_items)
        with torch.no_grad():
            vc, ic = rs.retrieval_topk(host, users, cands, 101,
                                       torch.from_numpy(prior), 0.5)
            vd, idd = rs.retrieval_topk(models[0], users.to(dev),
                                        cands.to(dev), 101,
                                        torch.from_numpy(prior).to(dev),
                                        0.5)
        check(vd.dtype == torch.float64, "the f64 prior did not promote")
        tol = 1e-4 * float(vc.abs().max())
        gap = vc[:, :-1] - vc[:, 1:]
        firm = torch.ones((4, 100), dtype=torch.bool)
        firm[:, 1:] &= gap[:, :99] > tol
        firm &= gap[:, :100] > tol
        agree = (idd[:, :100].cpu() == ic[:, :100]) | ~firm
        check(bool(agree.all()),
              f"two-tower top-100 card vs CPU differ at "
              f"{(~agree).nonzero().tolist()[:10]}")
        top = (f"; top-100 of 4 users over {cfg.n_items} candidates "
               f"(f64 prior, before the steps): {int(firm.sum())} of 400 "
               f"positions separated by > {tol:.1e}, all equal to the "
               f"CPU's")
    oc = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(loss_fn, oc)
    st_c, st_d = init_opt_state(host), init_opt_state(models[0])
    st_e = init_opt_state(models[1])
    losses = []
    for s in range(3):
        bs = batch_fn(s)
        _, _, mc = step(host, st_c, bs)
        _, _, md = step(models[0], st_d, to_device(bs, dev))
        if s == 0:
            step(models[1], st_e, to_device(bs, dev))
            same = all(torch.equal(a, b) for a, b in zip(
                leaves(models[0].to_tree()) + leaves(st_d["m"])
                + leaves(st_d["v"]), leaves(models[1].to_tree())
                + leaves(st_e["m"]) + leaves(st_e["v"])))
            check(same, f"{arch}: two identical card steps differ")
        losses.append((float(md["loss"]), float(mc["loss"])))
    lerr = max(abs(a - b) / abs(b) for a, b in losses)
    check(lerr <= 1e-4 and all(np.isfinite(a) for a, _ in losses),
          f"{arch}: 3-step losses card vs CPU {losses}")
    line = (f"[3g card vs cpu {arch}] rows cut {kw}, batch {b_cmp}: "
            f"rel err logits {errs['logits']:.2e} loss "
            f"{errs['loss']:.2e} grads (max over "
            f"{len(leaves(gc))} leaves) {errs['grads']:.2e}; 3-step "
            f"losses {[round(a, 6) for a, _ in losses]} rel err "
            f"{lerr:.2e}; two identical card steps bit-equal{top}")
    return line


def recsys_phase():
    """Phase 3g: the example ports and the recsys family on the card.

    (a) The five example ports (``examples/*_torch.py``) as subprocesses
    on the card, run together, each held to the JAX package's lines
    (``example_problems``). (b) Card against the host CPU at full widths
    with the rows cut (vocab per field 1,000 for dlrm-rm2 and dcn-v2,
    100k for bst; two-tower 10k users and 100k items), batch 512, from the
    same parameters (the CPU module's, carried to the card) and batch:
    logits, loss and every gradient within 1e-4 of the CPU's, relative
    to the largest magnitude; 3 train steps' losses within 1e-4
    relative; two identical card steps give the same bits (params and
    moments); for the two-tower the top-100 of 4 users over the 100k
    candidates with a float64 prior equals the CPU's wherever adjacent
    scores differ by more than 1e-4 of the largest. TF32 must be off.
    (c) ``python -m repro_torch.launch.train`` at full ``CONFIG`` with
    batch 65,536, 20 steps, for dlrm-rm2, dcn-v2 and bst (bst with
    ``--ckpt``, then ``--resume`` to 22 steps); the two-tower in this
    process at 1M users and items, batch 8,192 (``StepTimer``): median
    step ms (CUDA events, after 2 warm-up steps), the wall a step with the
    host's batch build and H2D, samples/s over that wall, the batch
    build's share of it, peak allocated memory, first and last loss, all
    finite. (d) Retrieval at the full two-tower
    ``CONFIG`` (10M x 256 tables, forward only): the card's
    ``accel_hits`` prior on ``bipartite_interactions(1M, 1M, 10M, seed
    0)``, 256 users against 1M candidates, k 100, with and without the
    prior (which must raise the top-k's mean authority); ms of HITS, the
    towers, the scores and the top-k. Its files (the examples' spills,
    bst's checkpoint: ~3.9 GB) go under a temporary directory that is
    removed however the phase ends. Returns the median step ms of the
    three ``launch.train`` runs, by arch."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke_3g_")
    try:
        return _recsys_phase(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _recsys_phase(tmp):
    """The body of ``recsys_phase``, writing its files under ``tmp``."""
    import dataclasses
    import os
    import re
    import shutil
    import statistics

    import torch
    from repro_torch.configs import get_spec
    from repro_torch.core import accel_hits
    from repro_torch.graph import bipartite_interactions
    from repro_torch.launch.train import StepTimer
    from repro_torch.models import recsys as rs
    from repro_torch.train import (AdamWConfig, DataConfig, adamw_update,
                                   init_opt_state, make_train_step,
                                   recsys_batch, to_device, twotower_batch,
                                   value_and_grad)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: the card would not hold the CPU's f32 results")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)

    # ------------------------------------------------ (a) the examples
    t0 = time.perf_counter()
    procs = {}
    for name in EXAMPLE_LINES:
        log = open(os.path.join(tmp, f"{name}.log"), "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / f"{name}_torch.py")],
            stdout=log, stderr=subprocess.STDOUT, text=True, env=env,
            cwd=tmp), log)
    for name, (proc, log) in procs.items():
        try:
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
        log.seek(0)
        out = log.read()
        log.close()
        problems = example_problems(name, out) if rc == 0 else [f"rc {rc}"]
        check(not problems, f"examples/{name}_torch.py on the card: "
                            f"{problems}\n{out[-3000:]}")
        keep = [x for x in out.splitlines() if re.search(
            r"iterations|iters|sweeps|hits|L1=|queries from|restored|"
            r"authority|loss=", x)]
        print(f"[3g example {name}] matches the JAX package's lines; "
              + " | ".join(x.strip() for x in keep[:8]), flush=True)
    print(f"[3g examples] 5 ports on the card, run together: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # ------------------------------------- (b) card against the host CPU
    for arch, kw in RECSYS_ROWS_CUT.items():
        print(recsys_vs_host(arch, kw, dev), flush=True)
    torch.cuda.empty_cache()
    loss_fn = lambda m, b: m.loss(b)  # noqa: E731

    # --------------------------------------- (c) training at full config
    step_re = re.compile(r"step\s+(\d+) loss (\S+) lr (\S+) gnorm (\S+)")
    time_re = re.compile(r"timing: step ms median (\S+) over (\d+) steps "
                         r"\(CUDA events\); wall ms a step (\S+) .*?, "
                         r"(\d+) samples/s over the wall; batch build ms "
                         r"median (\S+) .*?, H2D ms median (\S+) .*?; "
                         r"peak allocated (\S+) GB")

    def timing_line(t, peak_gb):
        return (f"step ms median {t['step']:.3f} (CUDA events, {t['n']} "
                f"steps after 2 warm-up); wall ms a step {t['wall_ms']:.3f} "
                f"(host clock, batch build and H2D included), "
                f"{t['samples_per_s']:.0f} samples/s over the wall; batch "
                f"build {t['build']:.3f} ms (host clock, "
                f"{t['build'] / t['wall_ms']:.1%} of the wall), H2D "
                f"{t['h2d']:.3f} ms; peak allocated {peak_gb:.2f} GB")
    big = 65536

    def train(arch, *extra):
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             arch, "--batch", str(big), *extra], capture_output=True,
            text=True, env=env, cwd=tmp, timeout=600)
        wall = time.perf_counter() - t0
        check(r.returncode == 0, f"launch.train {arch} {extra}: rc "
                                 f"{r.returncode}\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-3000:]}")
        steps = step_re.findall(r.stdout)
        check(steps and all(np.isfinite(float(x[1])) for x in steps),
              f"launch.train {arch}: losses {steps}")
        return r.stdout, steps, time_re.search(r.stdout), wall

    ck_dir = os.path.join(tmp, "bst_ckpt")
    train_ms = {}
    for arch in ("dlrm-rm2", "dcn-v2", "bst"):
        extra = ["--steps", "20"]
        if arch == "bst":
            extra += ["--ckpt", ck_dir, "--ckpt-every", "20"]
        out, steps, tm, wall = train(arch, *extra)
        check(tm is not None, f"launch.train {arch}: no timing line\n{out}")
        t = dict(step=float(tm.group(1)), n=int(tm.group(2)),
                 wall_ms=float(tm.group(3)), samples_per_s=int(tm.group(4)),
                 build=float(tm.group(5)), h2d=float(tm.group(6)))
        train_ms[arch] = t["step"]
        print(f"[3g train {arch}] full CONFIG, batch {big}, 20 steps: "
              f"{timing_line(t, float(tm.group(7)))}; "
              f"loss first {float(steps[0][1]):.4f} (step {steps[0][0]}) "
              f"last {float(steps[-1][1]):.4f} (step {steps[-1][0]}); "
              f"process wall {wall:.1f} s", flush=True)
    out, steps, _tm, wall = train("bst", "--steps", "22", "--ckpt", ck_dir,
                                  "--ckpt-every", "20", "--resume")
    check("resumed from step 20" in out and "done: 2 steps" in out,
          f"bst did not resume from its checkpoint\n{out}")
    size = sum(os.path.getsize(os.path.join(dp, f))
               for dp, _d, fs in os.walk(ck_dir) for f in fs)
    shutil.rmtree(ck_dir, ignore_errors=True)
    print(f"[3g train bst resume] resumed from step 20 (checkpoint "
          f"{size / 1e9:.2f} GB of npz), 2 more steps, loss "
          f"{float(steps[-1][1]):.4f}; process wall {wall:.1f} s",
          flush=True)

    # where a full-config dlrm-rm2 step goes: forward + backward, then
    # AdamW (global-norm clip included) over its 1.66 G f32 parameters
    cfg = get_spec("dlrm-rm2").config
    model = rs.build(cfg, seed=0, device=dev)
    st = init_opt_state(model)
    oc = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    bs = to_device(recsys_batch(DataConfig(
        kind="recsys", global_batch=big, sparse_vocab=cfg.vocab_per_field),
        0), dev)
    fb_ms, opt_ms = [], []
    for _ in range(4):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        _, grads = value_and_grad(loss_fn, model, bs)
        b.record()
        adamw_update(model, grads, st, oc)
        c.record()
        torch.cuda.synchronize()
        fb_ms.append(a.elapsed_time(b))
        opt_ms.append(b.elapsed_time(c))
        del grads
    n_par = sum(p.numel() for p in model.parameters())
    adam_b = 7 * 4 * n_par  # read p, g, m, v; write p, m, v (f32)
    clip_b = 3 * 4 * n_par  # the norm reads g; the scale reads, writes g
    print(f"[3g dlrm-rm2 step split] full CONFIG, batch {big} (3 steps after "
          f"1 warm-up, CUDA events): forward + backward "
          f"{statistics.median(fb_ms[1:]):.3f} ms, AdamW with the clip "
          f"{statistics.median(opt_ms[1:]):.3f} ms over {n_par:,} f32 "
          f"parameters; AdamW's byte bound {adam_b / 1e9:.1f} GB = "
          f"{adam_b / HBM_BYTES_PER_S * 1e3:.3f} ms, with the clip's "
          f"{(adam_b + clip_b) / 1e9:.1f} GB = "
          f"{(adam_b + clip_b) / HBM_BYTES_PER_S * 1e3:.3f} ms", flush=True)
    del model, st, bs
    torch.cuda.empty_cache()

    # the two-tower in this process: 1M users and items, batch 8,192
    tt_cfg = dataclasses.replace(get_spec("two-tower-retrieval").config,
                                 n_users=1_000_000, n_items=1_000_000)
    tt_b = 8192
    torch.cuda.reset_peak_memory_stats(dev)
    model = rs.build(tt_cfg, seed=0, device=dev)
    dc = DataConfig(kind="twotower", global_batch=tt_b)
    step = make_train_step(loss_fn, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=20))
    st = init_opt_state(model)
    timer, losses = StepTimer(dev), []
    for s in range(20):
        with timer.span("build"):
            bs = twotower_batch(dc, s, tt_cfg.n_users, tt_cfg.n_items)
        with timer.span("h2d"):
            bs = to_device(bs, dev)
        with timer.span("step"):
            _, st, m = step(model, st, bs)
        losses.append(m["loss"])
    t = timer.summary(tt_b)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"two-tower losses {losses}")
    print(f"[3g train two-tower-retrieval] in process, 1M users and items "
          f"(rows cut from 10M), batch {tt_b} (cut from 65,536): "
          f"{timing_line(t, torch.cuda.max_memory_allocated(dev) / 1e9)}; "
          f"loss first {losses[0]:.4f} last {losses[-1]:.4f}", flush=True)
    del model, st, step
    torch.cuda.empty_cache()

    # ------------------------------------- (d) retrieval at full CONFIG
    cfg = get_spec("two-tower-retrieval").config
    t0 = time.perf_counter()
    model = rs.build(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_u = n_i = 1_000_000
    gb = bipartite_interactions(n_u, n_i, 10_000_000, seed=0)
    gen_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = accel_hits(gb, tol=1e-9, device=dev)
    hits_ms = (time.perf_counter() - t0) * 1e3
    check(r.converged and np.isfinite(r.aux).all(),
          f"accel_hits on the interaction graph: {r.iters} iters, "
          f"converged {r.converged}")
    prior = torch.from_numpy(r.aux[n_u:] + 1e-12).to(dev)
    users = torch.arange(256, device=dev)
    cands = torch.arange(1_000_000, device=dev)

    def ev_ms(fn, n=3):
        fn()
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            out = fn()
        b.record()
        torch.cuda.synchronize()
        return out, a.elapsed_time(b) / n

    with torch.no_grad():
        v, item_ms = ev_ms(lambda: rs.item_embed(model, cands))
        u, user_ms = ev_ms(lambda: rs.user_embed(model, users))
        sc, score_ms = ev_ms(lambda: u @ v.T + 0.5 * torch.log(
            prior + 1e-12)[None, :])
        (_, blended), topk_ms = ev_ms(lambda: rs.topk(sc, 100))
        (_, base), _ms = ev_ms(lambda: rs.topk(u @ v.T, 100), 1)
        (vals, idx), call_ms = ev_ms(lambda: rs.retrieval_topk(
            model, users, cands, 100, prior, 0.5), 1)
    check(torch.equal(idx, blended) and vals.dtype == torch.float64
          and vals.shape == (256, 100) and torch.isfinite(vals).all(),
          "retrieval_topk differs from its steps")
    mb, mp = float(prior[base].mean()), float(prior[blended].mean())
    check(mp > mb, f"the prior did not raise the top-k's mean authority: "
                   f"base {mb:.3e} blended {mp:.3e}")
    flops = 2 * 1_000_000 * sum(a * b for a, b in zip(
        (cfg.embed_dim,) + cfg.tower_mlp[:-1], cfg.tower_mlp))
    print(f"[3g retrieval] full two-tower CONFIG (2 x {cfg.n_items:,} x "
          f"{cfg.embed_dim} f32 tables, init {init_s * 1e3:.1f} ms): "
          f"prior = "
          f"accel_hits on bipartite_interactions(1M, 1M, 10M, seed 0) "
          f"({gb.n_edges:,} edges after dedup, generated in {gen_s:.1f} s "
          f"on the host): {r.iters} sweeps, {hits_ms:.1f} ms wall on the "
          f"card; 256 users x 1M candidates, k 100: item tower "
          f"{item_ms:.3f} ms ({flops / 1e12:.3f} TFLOP f32, bound "
          f"{flops / PEAK_FLOPS['float32'] * 1e3:.3f} ms), user tower "
          f"{user_ms:.3f} ms, scores + prior (f64) {score_ms:.3f} ms, "
          f"top-k {topk_ms:.3f} ms, whole retrieval_topk call "
          f"{call_ms:.3f} ms; mean authority of the top-100 base "
          f"{mb:.3e} blended {mp:.3e}", flush=True)
    del model, v, u, sc
    torch.cuda.empty_cache()
    print(f"[3g] phase 3g: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return train_ms


# ---------------------------------------- phase 3j: the dry-run tools
DRYRUN_CELLS = (("pod1", "minitron-4b", "train_4k"),
                ("pod1", "gin-tu", "ogb_products"),
                ("pod1", "dlrm-rm2", "train_batch"),
                ("pod1", "hits-webgraph", "webrank_200m"),
                ("pod1", "mixtral-8x7b", "train_4k"),
                ("pod1", "minitron-8b", "train_4k"),
                ("host", "gin-tu", "ogb_products"),
                ("host", "dlrm-rm2", "train_batch"))
# the dry-run's counts on small meshes with every redistribution its own
# (``--strict``: none chosen by DTensor): collective bytes moved by kind,
# the number of collectives, FLOPs and HBM bytes a device, fixed whatever
# the torch version, by (arch, shape, mesh shape): one cell at least of
# each family of redistributions the dry-run makes itself (a sharded sort,
# the in-batch diagonal, GIN's seed slice, decode over a position-sharded
# cache, MoE decode and dispatch, GQA heads over model=16, MoE training
# with the experts on data or on model, its buffer sharded unevenly on
# (16, 2), each FSDP weight gathered once for a layer's recompute and
# backward; the two-tower's in-batch products split on the items' model
# shards).
# ``tests/test_torch_dryrun.py`` holds them on the host and against the JAX
# package's HLO; phase 3j on the card's machine
DRYRUN_PINNED = {
    ("minitron-4b", "train_4k", (2, 4)): (
        {"all-reduce": 1466552574008.0, "all-gather": 2378170368.0}, 510,
        7062096237898814.0, 158523215811852.0),
    ("gin-tu", "ogb_products", (2, 4)): (
        {"all-gather": 247447552.0, "all-reduce": 12539028480.0}, 12,
        742919342077.0, 517659039208.0),
    ("dlrm-rm2", "train_batch", (2, 4)): (
        {"all-reduce": 3770305056.0}, 19,
        165605957492.0, 81653801832.0),
    ("dlrm-rm2", "retrieval_cand", (2, 4)): (
        {"all-reduce": 6656000000.0, "all-gather": 4000000.0}, 2,
        808846500000.0, 51567054844.0),
    ("two-tower-retrieval", "train_batch", (2, 4)): (
        {"all-reduce": 10882793552.0, "collective-permute": 50331648.0,
         "all-gather": 67108864.0}, 35,
        1809537427491.0, 355464618456.0),
    ("gin-tu", "minibatch_lg", (2, 4)): (
        {"all-gather": 435159040.0,
         "all-reduce": 870980152.0,
         "collective-permute": 262144.0}, 51,
        34838724097.0, 11336811708.0),
    ("deepseek-7b", "decode_32k", (2, 4)): (
        {"all-reduce": 128909312.0, "all-gather": 62914560.0}, 241,
        467040873344.0, 2349749644432.0),
    ("mixtral-8x7b", "decode_32k", (2, 4)): (
        {"all-gather": 23497867264.0,
         "all-reduce": 470943744.0,
         "all-to-all": 16777216.0}, 707,
        649145927072.0, 286434002432.0),
    ("mixtral-8x7b", "prefill_32k", (2, 4)): (
        {"all-gather": 26441940992.0, "all-reduce": 3445687846912.0}, 675,
        6545726399595840.0, 334943720711300.0),
    ("minitron-8b", "train_4k", (2, 16)): (
        {"all-reduce": 1986177040440.0, "all-gather": 3170893824.0}, 766,
        6694563527880766.0, 92265984331020.0),
    ("mixtral-8x7b", "train_4k", (2, 4)): (
        {"all-gather": 53820260352.0, "all-reduce": 11603287232600.0,
         "reduce-scatter": 65536000.0}, 2006,
        1.832630687744905e+16, 238538519689476.0),
    ("deepseek-v2-236b", "train_4k", (2, 4)): (
        {"all-gather": 1474504949760.0, "all-reduce": 33738947307648.0,
         "reduce-scatter": 262144000.0}, 4650,
        4.7940410324076e+16, 1463695042553704.0),
    ("mixtral-8x7b", "train_4k", (16, 2)): (
        {"all-gather": 99887349760.0, "all-reduce": 8034387513432.0,
         "reduce-scatter": 131072000.0}, 2006,
        4440809020007332.0, 67211202342532.0),
}
# the DRYRUN_PINNED cells of one process, strict: argv[1] is JSON [[arch,
# shape, [mesh shape], name], ...]; prints {name: [by_kind,
# n_collective_ops, FLOPs, HBM bytes]} as JSON
DRYRUN_PIN_CODE = r"""
import json, sys
from repro_torch.configs import get_spec
from repro_torch.launch.dryrun import model_cell
from repro_torch.launch.steps import build_step
from repro_torch.sparse.dist import Mesh
out = {}
for arch, shape, mshape, name in json.loads(sys.argv[1]):
    mesh = Mesh(("meta",) * (mshape[0] * mshape[1]), tuple(mshape),
                ("data", "model"))
    r = model_cell(build_step(get_spec(arch), shape), mesh, "h100-sxm",
                   strict=True)
    c, rl = r["collectives"], r["roofline"]
    out[name] = [c["by_kind"], c["n_collective_ops"],
                 rl["flops_per_device"], rl["hbm_bytes_per_device"]]
print(json.dumps(out))
"""


def pin_name(arch, shape, mesh):
    """A pinned cell's name: "arch shape", and its mesh where the (2, 4) or
    (2, 16) mesh is not the one (``tests/test_torch_dryrun.py``'s)."""
    return f"{arch} {shape}" + ("" if mesh in ((2, 4), (2, 16)) else
                                f" {mesh[0]}x{mesh[1]}")


# the pinned cells split over processes that run at once (the slowest
# alone, the two MoE training cells together)
DRYRUN_PIN_GROUPS = (("mixtral-8x7b prefill_32k",), ("minitron-8b train_4k",),
                     ("deepseek-v2-236b train_4k",),
                     ("mixtral-8x7b train_4k", "mixtral-8x7b train_4k 16x2"))


def dryrun_phase(measured_ms, device="cuda"):
    """Phase 3j: ``python -m repro_torch.launch.dryrun`` on this
    machine's host CPU, one subprocess a cell, all started together:
    ``DRYRUN_CELLS`` (one cell of each family on the pod1 mesh of 256
    logical devices, with mixtral-8x7b's MoE dispatch and minitron-8b's
    GQA heads over model=16 among them; gin-tu ogb_products and dlrm-rm2
    train_batch on the host mesh of this one card). Prints each cell's
    status and roofline terms at the H100 SXM data-sheet rates
    (predictions, not measurements); a cell that is not ``ok`` fails the phase. The host
    cells' roofline step time is printed beside the step this run
    measured (``measured_ms``, by arch: 3i (c), 3g). ``device`` is the
    host mesh's device type ("cpu" rehearses the phase without a card).
    Its JSONs go under a temporary directory that is removed however the
    phase ends. The model cells run ``--strict`` (no collective chosen by
    DTensor), and five more subprocesses hold ``DRYRUN_PINNED``'s cells
    on their small meshes to their pinned counts: this machine's torch
    places them as the host's does."""
    import os
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke_3j_")
    t_phase = time.perf_counter()
    try:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)
        procs = []
        for mesh, arch, shape in DRYRUN_CELLS:
            out = os.path.join(tmp, mesh)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", arch, "--shape", shape, "--mesh", mesh,
                 "--out", out, "--device", device, "--strict"], env=env,
                cwd=tmp, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE))
        groups = [[list(c) + [pin_name(*c)] for c in DRYRUN_PINNED
                   if pin_name(*c) in g] for g in DRYRUN_PIN_GROUPS]
        groups.insert(0, [list(c) + [pin_name(*c)] for c in DRYRUN_PINNED
                          if not any(pin_name(*c) in g
                                     for g in DRYRUN_PIN_GROUPS)])
        pins = [subprocess.Popen(
            [sys.executable, "-c", DRYRUN_PIN_CODE, json.dumps(g)], env=env,
            cwd=tmp, text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE) for g in groups]
        procs += pins
        for p, (mesh, arch, shape) in zip(procs, DRYRUN_CELLS):
            try:
                _out, err = p.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                fail(f"3j: the dry-run of {arch} {shape} {mesh} timed out")
            check(p.returncode == 0, f"3j: dryrun {arch} {shape} {mesh}: rc "
                                     f"{p.returncode}\n{err[-3000:]}")
            with open(os.path.join(tmp, mesh, f"{arch}__{shape}__{mesh}"
                                   "__baseline.json")) as f:
                r = json.load(f)
            check(r["status"] == "ok", f"3j: {arch} {shape} {mesh}: "
                  f"{r['status']}\n{r.get('traceback', '')}")
            rl, coll = r["roofline"], r["collectives"]
            line = (f"[3j dryrun {mesh} {arch} {shape}] ok, "
                    f"{rl['n_devices']} devices, {r['compile_s']} s on the "
                    f"host: compute {rl['compute_s'] * 1e3:.3f} ms, memory "
                    f"{rl['memory_s'] * 1e3:.3f} ms, collective "
                    f"{rl['collective_s'] * 1e3:.3f} ms (bottleneck "
                    f"{rl['bottleneck']}); per device "
                    f"{rl['flops_per_device']:.4e} FLOP, "
                    f"{rl['hbm_bytes_per_device']:.4e} B HBM, "
                    f"{rl['collective_bytes_per_device']:.4e} B moved in "
                    f"{coll['n_collective_ops']} collectives ("
                    + ", ".join(f"{k} {v:.4e}" for k, v in
                                sorted(coll['by_kind'].items()))
                    + f"); useful FLOP "
                    f"ratio {rl['useful_flops_ratio']:.4f}, roofline "
                    f"fraction {rl['roofline_fraction']:.4f}")
            if mesh == "host":
                got = measured_ms[arch]
                pred = rl["step_time_s"] * 1e3
                line += (f"; roofline step {pred:.3f} ms against "
                         f"{got:.3f} ms measured here (median step, CUDA "
                         f"events): {got / pred:.2f}x")
            print(line, flush=True)
        got = {}
        for pin in pins:
            try:
                out, err = pin.communicate(timeout=900)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                fail("3j: the pinned cells timed out")
            check(pin.returncode == 0, f"3j: pinned cells: rc "
                                       f"{pin.returncode}\n{err[-3000:]}")
            got.update(json.loads(out.strip().splitlines()[-1]))
        for (arch, shape, mesh), pinned in DRYRUN_PINNED.items():
            g = tuple(got[pin_name(arch, shape, mesh)])
            check(g == pinned, f"3j: {arch} {shape} on {mesh}: {g}, pinned "
                               f"{pinned}")
            print(f"[3j pinned {arch} {shape}] {mesh} mesh, strict: "
                  f"{g[0]} in {g[1]} collectives, {g[2]:.6e} FLOP and "
                  f"{g[3]:.6e} B HBM a device, as pinned", flush=True)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[3j] phase 3j: {time.perf_counter() - t_phase:.1f} s (rates of "
          f"the last cell: {r['hw']})", flush=True)


# ------------------------------------------------------ phase 3h: the LMs
LM_ARCHS = ("deepseek-v2-236b", "mixtral-8x7b", "deepseek-7b",
            "minitron-4b", "minitron-8b")
# card against the host CPU: f32 as the recsys family; bf16 in ulps at
# the largest magnitude M (ulp <= M * 2**-7), the CPU tests' bounds
LM_TOL = {"float32": {"out": 1e-4, "loss": 1e-4, "grad": 1e-4},
          "bfloat16": {"out": 2 ** -6, "loss": 2 ** -8, "grad": 2 ** -5}}
# decode against forward at full width (b): at f32 compute as the CPU
# tests hold it (1e-4 of the largest magnitude), at bf16 sixteen ulps at
# the largest magnitude (two bf16 paths through 30 layers: measured
# 3.46e-2 on deepseek-7b, H100 80GB HBM3, 700 W)
LM_DECODE_TOL = {"float32": 1e-4, "bfloat16": 2 ** -4}
# full-width serving (b): layers kept of each CONFIG (memory on one 80 GB
# card: mixtral's 32 layers are 93 GB of bf16, deepseek-v2's 60 are 472)
LM_SERVE_LAYERS = {"deepseek-7b": 30, "mixtral-8x7b": 16,
                   "deepseek-v2-236b": 4}


class RouteLog:
    """While installed, records every MoE dispatch's routing on the device
    it runs on: each token's top-k experts, sorted (``calls``), and
    whether the capacity dropped one of its slots (``drops``). Two runs
    of the same calls pair call i with call i, so a token routed
    differently (a near-tie resolved otherwise by a last-bit difference
    upstream) is found, not guessed."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        from repro_torch.models.recsys import topk
        self.calls, self.drops, self._orig = [], [], moe._dispatch

        def rec(x, router_w, top_k, c):
            g = torch.softmax(x.float() @ router_w.float(), dim=-1)
            self.calls.append(topk(g, top_k)[1].sort(-1).values.cpu())
            out = self._orig(x, router_w, top_k, c)
            self.drops.append((out[1] < 0).any(-1).cpu())
            return out
        moe._dispatch = rec
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe._dispatch = self._orig


def rerouted(a, b):
    """Per call, the tokens whose experts differ between two RouteLogs."""
    check(len(a.calls) == len(b.calls), "route logs of unequal length")
    return [(x != y).any(-1) for x, y in zip(a.calls, b.calls)]


def rel_err(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def lm_vs_host(arch, cdt, dev, b=4, s=32, steps=30):
    """Phase 3h (a) for one smoke config at one compute dtype: the card
    against the host CPU from the same parameters and batch. Returns
    (line, problems). Forward logits, loss and every gradient within
    ``LM_TOL``; ``steps`` greedy decode steps (the card fed the host's
    tokens), logits within ``LM_TOL`` and argmax equal where the host's
    top-two margin exceeds it; rows with a token routed differently
    (``RouteLog``) are left out of the logits and counted, and the loss
    and gradients are compared only when no token was; ``kvquant`` of
    the host's cache on both devices: int8 values and scales bit-equal,
    the round trip within half a scale, its attention within ``LM_TOL``;
    two identical card decode runs and train steps (parameters and
    moments) bit-equal."""
    import dataclasses

    import torch
    from repro_torch.configs import get_spec
    from repro_torch.models import Transformer
    from repro_torch.serve import kvquant as kq
    from repro_torch.train import (AdamWConfig, DataConfig, init_opt_state,
                                   lm_batch, make_train_step, to_device,
                                   value_and_grad)
    from repro_torch.tree import leaves
    cfg = dataclasses.replace(get_spec(arch).smoke_config,
                              compute_dtype=cdt)
    tol, bad = LM_TOL[cdt], []
    host = Transformer(cfg, seed=0, device="cpu")
    cards = [Transformer(cfg, seed=1, device=dev).params_from_reference(
        host.to_tree()) for _ in range(2)]
    batch = lm_batch(DataConfig(kind="lm", global_batch=b, seq_len=s,
                                vocab=cfg.vocab), 0)
    bd = to_device(batch, dev)

    def logits(m, toks):
        with torch.no_grad():
            x, _ = m(toks)
            return torch.einsum("bsd,dv->bsv", x, m.unembed.to(x.dtype))
    with RouteLog() as rh:
        lh = logits(host, batch["tokens"])
    with RouteLog() as rd:
        ld = logits(cards[0], bd["tokens"]).cpu()
    moved = [t.nonzero().ravel() for t in rerouted(rh, rd)]
    n_fwd = sum(len(t) for t in moved)
    rows = sorted({int(t) // s for m in moved for t in m})
    keep = [r for r in range(b) if r not in rows]
    errs = {"logits": rel_err(ld[keep], lh[keep]) if keep else 0.0}
    loss_fn = lambda m, bb: m.loss(bb)  # noqa: E731
    lc, gc = value_and_grad(loss_fn, host, batch)
    lg, gd = value_and_grad(loss_fn, cards[0], bd)
    if not n_fwd:
        errs["loss"] = rel_err(lg, lc)
        errs["grads"] = max(rel_err(a, c) for a, c in zip(leaves(gd),
                                                          leaves(gc)))
    if errs["logits"] > tol["out"] or errs.get("loss", 0) > tol["loss"] \
            or errs.get("grads", 0) > tol["grad"] or \
            not torch.isfinite(lg):
        bad.append(f"forward {errs}")

    # decode: the host greedy, the card fed the host's tokens (twice)
    def decode(m, feed=None):
        cache = m.init_cache(b, steps + 2)
        tok, out, toks = batch["tokens"][:, 0].to(m.embed.device), [], []
        with RouteLog() as log:
            for pos in range(steps):
                lgt, cache = m.decode_step(cache, tok, pos)
                out.append(lgt.float().cpu())
                toks.append(lgt.argmax(-1).cpu())
                tok = (toks[-1] if feed is None else feed[pos]).to(
                    m.embed.device)
        return out, toks, cache, log
    hl, ht, hcache, hlog = decode(host)
    dl, _, dcache, dlog = decode(cards[0], ht)
    dl2, _, _, _ = decode(cards[0], ht)
    if not all(torch.equal(x, y) for x, y in zip(dl, dl2)):
        bad.append("two identical card decode runs differ")
    moved = rerouted(hlog, dlog)
    per_step = len(moved) // steps if moved else 0
    gone, derr, firm, n_dec = set(), 0.0, 0, 0
    for pos in range(steps):
        for t in moved[pos * per_step:(pos + 1) * per_step]:
            gone |= set(t.nonzero().ravel().tolist())
            n_dec += int(t.sum())
        keep = [r for r in range(b) if r not in gone]
        if not keep:
            break
        want, got = hl[pos][keep], dl[pos][keep]
        derr = max(derr, rel_err(got, want))
        top2 = want.sort(-1).values[:, -2:]
        sure = (top2[:, 1] - top2[:, 0]) > tol["out"] * float(
            want.abs().max())
        if not torch.equal(got.argmax(-1)[sure], ht[pos][keep][sure]):
            bad.append(f"decode step {pos}: argmax differs")
        firm += int(sure.sum())
    if derr > tol["out"]:
        bad.append(f"decode logits rel err {derr:.2e}")

    # kvquant: the host's cache quantized on both devices
    name = "k" if "k" in hcache else "ckv"
    kv = hcache[name][0]
    kv = kv if kv.dim() == 4 else kv[:, :, None, :]
    qh, sh = kq.quantize_kv(kv)
    qd, sd = kq.quantize_kv(kv.to(dev))
    if not (torch.equal(qh, qd.cpu()) and torch.equal(sh, sd.cpu())):
        bad.append("kvquant int8 or scales differ between card and host")
    rt_err = float(((kq.dequantize_kv(qh, sh) - kv.float()).abs()
                    - sh * (0.5 + 1e-5)).max())
    layer = {"k_q": qh, "k_s": sh, "v_q": qh, "v_s": sh}
    q = torch.randn((b, kv.shape[2] * 2, kv.shape[3]),
                    generator=torch.Generator().manual_seed(0))
    ah = kq.quant_decode_attention(q, layer, steps)
    ad = kq.quant_decode_attention(q.to(dev), {k: v.to(dev) for k, v in
                                               layer.items()}, steps)
    qerr = rel_err(ad, ah)
    if rt_err > 0 or qerr > 1e-4:
        bad.append(f"kvquant round trip {rt_err:.2e}, attention {qerr:.2e}")

    # two identical card train steps
    step = make_train_step(loss_fn, AdamWConfig(lr=1e-3, warmup_steps=1))
    sts = [init_opt_state(m) for m in cards]
    for m, st in zip(cards, sts):
        step(m, st, bd)
    if not all(torch.equal(x, y) for x, y in zip(
            leaves(cards[0].to_tree()) + leaves(sts[0]["m"])
            + leaves(sts[0]["v"]), leaves(cards[1].to_tree())
            + leaves(sts[1]["m"]) + leaves(sts[1]["v"]))):
        bad.append("two identical card train steps differ")
    grads = (f"loss {errs['loss']:.2e} grads (max over {len(leaves(gc))} "
             f"leaves) {errs['grads']:.2e}" if "loss" in errs else
             f"loss and grads not compared ({n_fwd} tokens routed "
             f"differently)")
    line = (f"[3h card vs cpu {arch} {cdt}] smoke, batch {b} x {s}: rel "
            f"err logits {errs['logits']:.2e} (rows {rows} left out: "
            f"routed differently), {grads}; {steps} decode steps: logits "
            f"{derr:.2e}, argmax equal at the {firm} firm positions, "
            f"{n_dec} token-steps routed differently; kvquant int8 and "
            f"scales bit-equal, attention {qerr:.2e}; two identical card "
            f"decode runs and train steps bit-equal")
    return line, bad


def weight_bytes(model, batch: int) -> int:
    """The bytes a decode step must read of the weights, once each at
    their stored dtype: the embedding's B gathered rows and every other
    leaf whole (the dense MoE products read every expert)."""
    return sum((batch * p.shape[1] if name == "embed" else p.numel())
               * p.element_size() for name, p in model.named_parameters())


def lm_phase():
    """Phase 3h: the LM family on the card.

    (a) ``lm_vs_host`` for each of the five smoke configs at its own
    compute dtype and at f32. (b) Serving at full width through
    ``repro_torch.launch.serve``'s functions (``load``, ``generate``),
    batch 8, prompt 64, gen 192: deepseek-7b whole, mixtral-8x7b with 16
    of 32 layers, deepseek-v2-236b with 4 of 60 (``LM_SERVE_LAYERS``):
    tokens/s over the wall, the median decode step (CUDA events), peak
    ``max_memory_allocated`` and the step's byte bound (``weight_bytes``
    over 3.35 TB/s); decode's logits against ``forward``'s for the first
    8 positions (bf16, rows with a token routed differently left out);
    then one ``decode_32k`` step of deepseek-7b at batch 1, ``pos`` 32767,
    over a seeded random cache of 32,768 positions. (c) minitron-4b
    trained through ``launch.train``'s LM branch (``model_and_data``,
    ``make_train_step``, ``StepTimer``): 8 of 32 layers, seq 4096, batch
    2, 5 steps, remat on: step ms, peak GB, finite losses. (d)
    ``examples/serve_decode_torch.py`` and ``train_lm_torch.py`` on the
    card, held to ``LM_EXAMPLE_LINES``."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke_3h_")
    try:
        _lm_phase(tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _lm_phase(tmp):
    import dataclasses
    import os
    import statistics

    import torch
    from repro_torch.configs import get_spec
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.train import StepTimer, model_and_data
    from repro_torch.models.transformer import (decode_step, forward,
                                                init_cache)
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, to_device)
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)

    # ------------------------------------- (a) card against the host CPU
    t0 = time.perf_counter()
    for arch in LM_ARCHS:
        own = get_spec(arch).smoke_config.compute_dtype
        for cdt in (own, "float32"):
            line, bad = lm_vs_host(arch, cdt, dev)
            print(line, flush=True)
            check(not bad, f"{arch} {cdt}: card vs CPU {bad}")
    print(f"[3h (a)] {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ------------------------------------ (b) serving at full width
    b, prompt, gen = 8, 64, 192
    for arch, n_layers in LM_SERVE_LAYERS.items():
        full = get_spec(arch).config
        cfg = dataclasses.replace(full, n_layers=n_layers)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model, cache, prompts = lserve.load(cfg, b, prompt, gen, device=dev)
        torch.cuda.synchronize(dev)
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        torch.cuda.reset_peak_memory_stats(dev)
        timer = StepTimer(dev, warmup=0)
        t0 = time.perf_counter()
        out = lserve.generate(model, cache, prompts, gen, span=timer.span)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        step_ms = [a.elapsed_time(c) for a, c in timer.marks["step"]]
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        check(out.shape == (b, gen) and bool(((out >= 0)
                                              & (out < cfg.vocab)).all()),
              f"{arch}: generated {tuple(out.shape)}")
        wb = weight_bytes(model, b)
        # where a step goes: 4 more steps (at the last position) under the
        # profiler: the device's busy time against the steps' CUDA-event
        # time, and the three kernels that take most of it
        from torch.profiler import ProfilerActivity, profile
        last = out[:, -1]
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a, c = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(4):
                model.decode_step(cache, last, prompt + gen - 1)
            c.record()
            torch.cuda.synchronize(dev)
        prof_ms = a.elapsed_time(c) / 4
        busy = device_split(prof)["all"] / 4
        top = sorted(((getattr(e, "self_device_time_total", 0) or 0, e.key)
                      for e in prof.key_averages()), reverse=True)[:3]
        top = ", ".join(f"{k[:48]} {us / 4e3:.2f}" for us, k in top)
        # decode against forward for the first 8 positions: at f32 compute
        # (the same weights) a check of the computation, at bf16 of its
        # rounding (two bf16 paths through every layer)
        vs = {}
        for cdt in ("float32", cfg.compute_dtype):
            c2 = dataclasses.replace(cfg, compute_dtype=cdt)
            cache2 = init_cache(c2, b, 8, device=dev)
            with RouteLog() as dlog, torch.no_grad():
                dec = torch.stack([decode_step(model, cache2, prompts[:, p], p,
                                               c2)[0].float()
                                   for p in range(8)], 1)
            with RouteLog() as flog, torch.no_grad():
                x, _ = forward(model, prompts[:, :8], c2)
                fwd = torch.einsum("bsd,dv->bsv", x,
                                   model.unembed.to(x.dtype)).float()
            # rows a token of which was routed differently, or dropped by
            # the forward's capacity (64 tokens share it; a decode step's 8
            # never fill it): their logits differ by design
            gone, dropped = set(), set()
            n_moe = len(flog.calls)
            for layer in range(n_moe):
                ft = flog.calls[layer].reshape(b, 8, -1)
                dropped |= set(flog.drops[layer].reshape(b, 8).any(-1)
                               .nonzero().ravel().tolist())
                for p in range(8):
                    dt = dlog.calls[p * n_moe + layer]
                    gone |= set((ft[:, p] != dt).any(-1).nonzero()
                                .ravel().tolist())
            keep = [r for r in range(b) if r not in gone | dropped]
            vs[cdt] = (rel_err(dec[keep], fwd[keep]) if keep else 0.0,
                       f"rows {sorted(gone)} routed differently, "
                       f"{sorted(dropped)} dropped by capacity, left out",
                       fwd)
            del cache2, dec, x
        vs["bf16 vs f32"] = rel_err(vs[cfg.compute_dtype][2],
                                    vs["float32"][2])
        med = statistics.median(step_ms)
        print(f"[3h serve {arch}] full width, {n_layers} of "
              f"{full.n_layers} layers ({sum(p.numel() for p in model.parameters()):,} "
              f"{cfg.param_dtype} parameters, init {init_s:.1f} s), batch "
              f"{b}, prompt {prompt}, gen {gen}: {b * gen / wall:.1f} tok/s "
              f"over the wall ({wall:.2f} s, {prompt + gen - 1} steps); "
              f"decode step ms median {med:.3f} (CUDA events), byte bound "
              f"{wb / 1e9:.2f} GB of weights = "
              f"{wb / HBM_BYTES_PER_S * 1e3:.3f} ms "
              f"({wb / HBM_BYTES_PER_S * 1e3 / med:.1%} of the median); "
              f"profiled steps {prof_ms:.3f} ms, device busy {busy:.3f} ms "
              f"of it (idle share {1 - busy / prof_ms:.3f}; most: {top} "
              f"ms a step); "
              f"peak allocated {peak:.2f} GB decoding ({init_peak:.2f} GB "
              f"in the init's f32 draws); decode vs forward, first 8 "
              f"positions, rel err at f32 compute {vs['float32'][0]:.2e} "
              f"({vs['float32'][1]}), at {cfg.compute_dtype} "
              f"{vs[cfg.compute_dtype][0]:.2e} ({vs[cfg.compute_dtype][1]};"
              f" the bf16 forward's own distance from the f32 one "
              f"{vs['bf16 vs f32']:.2e})", flush=True)
        for cdt in ("float32", cfg.compute_dtype):
            check(vs[cdt][0] <= LM_DECODE_TOL[cdt],
                  f"{arch}: decode vs forward at {cdt}: rel err "
                  f"{vs[cdt][0]:.2e}")
        del vs
        if arch == "deepseek-7b":
            cache = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            big = model.init_cache(1, 32768)
            g = torch.Generator(device=dev).manual_seed(SEED)
            for k in big:
                for i in range(big[k].shape[0]):
                    big[k][i].normal_(generator=g)
            tok = prompts[:1, 0]
            a, c = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            ms = []
            for _ in range(4):
                a.record()
                lg32 = model.decode_step(big, tok, 32767)[0]
                c.record()
                torch.cuda.synchronize(dev)
                ms.append(a.elapsed_time(c))
            cb = sum(v.numel() * v.element_size() for v in big.values())
            wb1 = weight_bytes(model, 1)
            check(bool(torch.isfinite(lg32).all()), "decode_32k: logits")
            print(f"[3h decode_32k deepseek-7b] batch 1 (cut from 128), pos "
                  f"32767 over a seeded random cache of 32,768 positions "
                  f"({cb / 1e9:.2f} GB bf16): step ms {ms[1:]} (CUDA events, "
                  f"after 1 warm-up), byte bound {(wb1 + cb) / 1e9:.2f} GB "
                  f"(weights + cache) = "
                  f"{(wb1 + cb) / HBM_BYTES_PER_S * 1e3:.3f} ms; peak "
                  f"allocated {torch.cuda.max_memory_allocated(dev) / 1e9:.2f}"
                  f" GB", flush=True)
            del big
        del model, cache, prompts
        torch.cuda.empty_cache()

    # ------------------------------------ (c) training at full width
    cfg = dataclasses.replace(get_spec("minitron-4b").config, n_layers=8)
    batch, seq, n_steps = 2, 4096, 5
    torch.cuda.reset_peak_memory_stats(dev)
    model, loss_fn, batch_fn = model_and_data(cfg, batch, 0, dev, seq=seq)
    step = make_train_step(loss_fn, AdamWConfig(lr=1e-4, warmup_steps=1,
                                                total_steps=n_steps))
    st = init_opt_state(model)
    timer, losses = StepTimer(dev, warmup=2), []
    for s in range(n_steps):
        with timer.span("build"):
            bs = batch_fn(s)
        with timer.span("h2d"):
            bs = to_device(bs, dev)
        with timer.span("step"):
            _, st, m = step(model, st, bs)
        losses.append(m["loss"])
    t = timer.summary(batch)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"minitron-4b losses {losses}")
    n_par = sum(p.numel() for p in model.parameters())
    # operations a step must do, as the reference computes them: bf16
    # products of the layers (forward, remat's recompute, backward x2),
    # f32 attention scores and values over every chunk (causal masking
    # computes them all) and f32 vocab logits (forward, the chunk's
    # recompute, backward x2)
    n_tok = batch * seq
    bf16_ops = 8 * sum(p.numel() for p in model.layers.parameters()) * n_tok
    f32_ops = 4 * (4 * batch * cfg.n_heads * seq ** 2 * cfg.d_head
                   * cfg.n_layers + 2 * n_tok * cfg.d_model * cfg.vocab)
    bound = (bf16_ops / PEAK_FLOPS["bfloat16"]
             + f32_ops / PEAK_FLOPS["float32"]) * 1e3
    print(f"[3h train minitron-4b] full width, 8 of 32 layers "
          f"({n_par:,} f32 parameters, {16 * n_par / 1e9:.1f} GB with "
          f"gradients and moments), seq {seq}, batch {batch} (cut from "
          f"256), remat on, {n_steps} steps through launch.train's "
          f"functions: step ms median {t['step']:.3f} (CUDA events, "
          f"{t['n']} steps after 2 warm-up), {batch * seq / t['step'] * 1e3:.0f} "
          f"tokens/s over the device step, wall ms a step "
          f"{t['wall_ms']:.3f}; operations bound {bound:.1f} ms "
          f"({bf16_ops / 1e12:.1f} TFLOP bf16, {f32_ops / 1e12:.1f} TFLOP "
          f"f32, {bound / t['step']:.1%} of the step); peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    del model, st, step
    torch.cuda.empty_cache()

    # ------------------------------------ (d) the LM examples on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)
    for name, want in LM_EXAMPLE_LINES.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples"
                                                / f"{name}_torch.py"),
                            *want["args"]], capture_output=True, text=True,
                           env=env, cwd=tmp, timeout=300)
        problems = lm_example_problems(name, r.stdout) if r.returncode == 0 \
            else [f"rc {r.returncode}"]
        check(not problems, f"examples/{name}_torch.py on the card: "
                            f"{problems}\n{r.stdout[-2000:]}"
                            f"{r.stderr[-2000:]}")
        print(f"[3h example {name}] {time.perf_counter() - t0:.1f} s: "
              + " | ".join(x.strip() for x in r.stdout.splitlines()[-2:]),
              flush=True)
    print(f"[3h] phase 3h: {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ------------------------------------------------------ phase 3i: the GNN
GNN_TOL = 1e-5      # card against the host CPU, of the largest magnitude
GNN_MAX_DEG = 1024  # minibatch_lg's sampler table: neighbors kept a node
GNN_STEPS = 5
GNN_CHECK_BLOCKS = 256  # ogb_products: first and last blocks held to plain


def gnn_smoke_batches(cfg, dev, seed=SEED):
    """Host batches of the three modes at smoke size, from a CPU
    generator, and the same on ``dev``: node (50 nodes, 200 edges, 8
    more with dst = N that the aggregation drops, a train mask), graph
    (8 padded graphs of 12 nodes, 30 edges) and sampled (16 seeds,
    fanouts (5, 3) over a 300-node webgraph, the draws made on the host
    and sampled on each device). Returns {mode: (host, on dev)}."""
    import torch
    from repro_torch.graph import (SamplerTables, WebGraphSpec,
                                   generate_webgraph, sample_khop)
    from repro_torch.train import to_device
    gen = torch.Generator().manual_seed(seed)
    n, e = 50, 200
    src = torch.cat([torch.randint(0, n, (e,), generator=gen),
                     torch.zeros(8, dtype=torch.long)])
    dst = torch.cat([torch.randint(0, n, (e,), generator=gen),
                     torch.full((8,), n)])
    node = {"x": torch.randn((n, cfg.d_in), generator=gen), "src": src,
            "dst": dst,
            "labels": torch.randint(0, cfg.n_classes, (n,), generator=gen),
            "train_mask": (torch.rand(n, generator=gen) > 0.3).float()}
    g_, n_, e_ = 8, 12, 30
    n_real = torch.randint(n_ // 2, n_ + 1, (g_,), generator=gen)
    e_real = torch.randint(e_ // 2, e_ + 1, (g_,), generator=gen)
    graph = {"x": torch.randn((g_, n_, cfg.d_in), generator=gen),
             "src": (torch.rand((g_, e_), generator=gen)
                     * n_real[:, None]).long(),
             "dst": (torch.rand((g_, e_), generator=gen)
                     * n_real[:, None]).long(),
             "node_mask": torch.arange(n_)[None, :] < n_real[:, None],
             "edge_mask": torch.arange(e_)[None, :] < e_real[:, None],
             "labels": torch.randint(0, cfg.n_classes, (g_,), generator=gen)}
    web = generate_webgraph(WebGraphSpec(300, 2400, 0.5, seed=5))
    fan, seeds = (5, 3), torch.arange(16)
    draws, b = [], len(seeds)
    for f in fan:
        draws.append(torch.randint(0, 2 ** 31 - 1, (b, f), generator=gen))
        b *= f
    feats = torch.randn((web.n_nodes, cfg.d_in), generator=gen)
    labels = torch.randint(0, cfg.n_classes, (16,), generator=gen)
    sampled = {}
    for d in ("cpu", dev):
        sub = sample_khop(SamplerTables.build(web, 32, device=d),
                          seeds.to(d), fan, draws=draws)
        sampled[d] = {"feats": feats.to(d)[sub.nodes.long()],
                      "edge_src": sub.edge_src, "edge_dst": sub.edge_dst,
                      "edge_mask": sub.edge_mask, "labels": labels.to(d),
                      "n_seeds": sub.n_seeds}
    for k in ("feats", "edge_src", "edge_dst", "edge_mask"):
        check(torch.equal(sampled["cpu"][k], sampled[dev][k].cpu()),
              f"3i: the card's sample differs from the host's in {k}")
    return {"node": (node, to_device(node, dev)),
            "graph": (graph, to_device(graph, dev)),
            "sampled": (sampled["cpu"], sampled[dev])}


def gnn_vs_host(dev, seed=SEED):
    """Phase 3i (a): ``gin-tu``'s smoke config, the host module's
    parameters carried to the card: each mode's loss (``node_loss``,
    ``graph_loss``, ``sampled_loss``) and every gradient within
    ``GNN_TOL`` of the host's, relative to the largest magnitude; on the
    card K3 launched 2 x layers times a forward and backward
    (``counters.seg_matmul``), nothing through its plain version; two
    identical card train steps of each mode bit-equal. Returns (the line
    to print, the problems)."""
    import torch
    from repro_torch.configs import get_spec
    from repro_torch.kernels import counters, reset_counters
    from repro_torch.models import gnn as pg
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step, value_and_grad)
    from repro_torch.tree import leaves
    cfg = get_spec("gin-tu").smoke_config
    card = torch.device(dev).type == "cuda"
    host = pg.GIN(cfg, seed=seed, device="cpu")
    losses = {"node": pg.node_loss, "graph": pg.graph_loss,
              "sampled": pg.sampled_loss}
    errs, bad, launches = {}, [], {}
    for mode, (hb, db) in gnn_smoke_batches(cfg, dev, seed).items():
        fn = lambda m, b, f=losses[mode]: f(m, b, cfg)  # noqa: E731
        lh, gh = value_and_grad(fn, host, hb)
        ms_ = [pg.GIN(cfg, seed=seed + 1, device=dev)
               .params_from_reference(host.to_tree()) for _ in range(2)]
        reset_counters()
        lc, gc = value_and_grad(fn, ms_[0], db)
        if card:
            torch.cuda.synchronize(dev)
        launches[mode] = counters.seg_matmul
        errs[mode] = max(rel_err(a, b) for a, b in
                         [(lc, lh)] + list(zip(leaves(gc), leaves(gh))))
        if errs[mode] > GNN_TOL:
            bad.append(f"{mode}: card vs host rel err {errs[mode]:.2e}")
        if card and launches[mode] != 2 * cfg.n_layers:
            bad.append(f"{mode}: K3 launched {launches[mode]} times, not "
                       f"{2 * cfg.n_layers}")
        step = make_train_step(fn, AdamWConfig(lr=1e-3, warmup_steps=1))
        states = [init_opt_state(m) for m in ms_]
        for m, st in zip(ms_, states):
            step(m, st, db)
        if not all(torch.equal(x, y) for x, y in zip(
                leaves(ms_[0].to_tree()) + leaves(states[0]["m"]),
                leaves(ms_[1].to_tree()) + leaves(states[1]["m"]))):
            bad.append(f"{mode}: two identical card steps differ")
    line = (f"[3i card vs cpu gin-tu-smoke] loss and every gradient, rel "
            f"err node {errs['node']:.2e} graph {errs['graph']:.2e} sampled "
            f"{errs['sampled']:.2e} (tol {GNN_TOL:g}); K3 launches a "
            f"forward + backward {launches} ({cfg.n_layers} layers); two "
            f"identical card steps of each mode bit-equal: "
            f"{not any('identical' in x for x in bad)}")
    return line, bad


def flat_edges(src, dst, n):
    """(src, dst, keep) of an edge set as the aggregation sees it: (G, E)
    tensors flattened with node offsets g·n, the edges outside [0, n)
    dropped (``keep``, flat, marks the edges kept)."""
    import torch
    src, dst = src.long(), dst.long()
    keep = (src >= 0) & (src < n) & (dst >= 0) & (dst < n)
    if src.dim() == 2:
        base = torch.arange(src.shape[0], device=src.device)[:, None] * n
        src, dst = src + base, dst + base
    keep = keep.reshape(-1)
    return src.reshape(-1)[keep], dst.reshape(-1)[keep], keep


def plain_rows(side, x, w, b0, b1):
    """Output rows [b0·bs, b1·bs) of ``side``'s sum (capped at its n_out)
    by ``seg_matmul_plain``, from the slots of blocks b0..b1-1 alone (K3's
    blocks are independent)."""
    from repro_torch.kernels.seg_matmul import seg_matmul_plain
    tp = side.tile_ptr.long()
    t0, t1 = int(tp[b0]), int(tp[b1])
    te = side.rows.shape[0] // side.blkid.shape[0]
    sl = slice(t0 * te, t1 * te)
    m = x.index_select(0, side.rows[sl])
    if w is not None:
        m.mul_(w.to(m.dtype).index_select(0, side.edge[sl])[:, None])
    y = seg_matmul_plain(side.blkid[t0:t1] - b0, m, side.off[sl],
                         side.valid[sl], b1 - b0, bs=side.bs)
    return y[:min(b1 * side.bs, side.n_out) - b0 * side.bs]


def agg_vs_plain(dev, src, dst, n, f=64, w=None, seed=SEED, lay=None,
                 blocks=None):
    """Phase 3i (b): the aggregation on the card at one edge set (``src``/
    ``dst`` (E,) over n nodes, or (G, E) over G graphs of n nodes; ``w``
    flat per edge; ``lay`` its ``EdgeLayouts``, else built here), forward
    and backward (2 K3 launches), K3's output rows bit-equal to
    ``seg_matmul_plain`` on the card, forward and backward: every block,
    or with ``blocks`` the first and the last ``blocks`` blocks (their
    highest message offsets past 2^31 elements at ogb_products, where the
    plain version's f64 copy of every message does not fit); the ms of one
    K3 launch (forward), of the gather and of ``index_add_`` over the E
    unpadded messages, each by CUDA events over repeated calls (late in a
    long process the profiler drops kernel events; at small shapes these
    times include the host's launch). Returns a dict of the numbers."""
    import torch
    from repro_torch.kernels import counters, reset_counters
    from repro_torch.kernels.ops import EdgeLayouts, aggregate
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_scratch_sizes
    gen = torch.Generator(device=dev).manual_seed(seed)
    if lay is None:
        lay = EdgeLayouts.build(src, dst, n)
    fw, nt = lay.fwd, lay.n_nodes
    h = torch.randn((nt, f), generator=gen, device=dev, requires_grad=True)
    gout = torch.randn((nt, f), generator=gen, device=dev)
    torch.cuda.synchronize(dev)
    reset_counters()
    out = aggregate(h, lay, w)
    out.backward(gout)
    torch.cuda.synchronize(dev)
    launches = counters.seg_matmul
    check(launches == 2, f"3i (b): {launches} K3 launches, not 2")
    nb, bs = fw.n_blocks, fw.bs
    ranges = [(0, nb)] if blocks is None or 2 * blocks >= nb \
        else [(0, blocks), (nb - blocks, nb)]
    hd = h.detach()
    for b0, b1 in ranges:
        for what, side, x, y in (("forward", lay.fwd, hd, out),
                                 ("backward", lay.rev, gout, h.grad)):
            got = y[b0 * bs:b1 * bs]
            want = plain_rows(side, x, w, b0, b1)
            check(torch.equal(got, want),
                  f"3i (b) N={nt}: K3's {what} differs from its plain "
                  f"version in blocks {b0}-{b1 - 1} by "
                  f"{(got - want).abs().max().item():.3e}")
            del want
    te = fw.rows.shape[0] // fw.blkid.shape[0]
    top = int(fw.tile_ptr[ranges[-1][1]]) * te - 1  # the last slot checked
    del out, h, gout
    msgs = fw.messages(hd, w)
    t_k3 = ms(lambda: seg_matmul(fw.blkid, msgs, fw.off, fw.valid,
                                 fw.n_blocks, bs=fw.bs, tile_ptr=fw.tile_ptr,
                                 scratch=lay.scratch), 3)
    del msgs
    t_gather = ms(lambda: fw.messages(hd, w), 3)
    s_l, d_l, keep = flat_edges(src, dst, n)
    raw = hd.index_select(0, s_l)
    if w is not None:
        raw = raw * w[keep].to(raw.dtype)[:, None]
    zeros = torch.zeros((nt, f), device=dev)
    t_lib = ms(lambda: zeros.zero_().index_add_(0, d_l, raw), 3)
    e = int(s_l.shape[0])
    e_pad = fw.rows.shape[0]
    # the bytes K3's function must move: each message row read, one
    # destination index an edge, each output row written once
    moved = e * f * 4 + 4 * e + fw.n_blocks * fw.bs * f * 4
    ws = seg_scratch_sizes(fw.blkid.shape[0], fw.n_blocks, fw.bs, f, 4)[0]
    del raw
    return dict(n=nt, e=e, e_pad=e_pad, n_tiles=int(fw.blkid.shape[0]),
                launches=launches, checked=[(b0, b1 - 1) for b0, b1 in ranges],
                n_blocks=nb, top_elem=(top + 1) * f - 1, ms=t_k3, gather_ms=t_gather,
                library_ms=t_lib, ws_bytes=ws,
                bound_ms=moved / HBM_BYTES_PER_S * 1e3)


def agg_line(label, r):
    return (f"[3i agg {label}] N={r['n']:,} E={r['e']:,} e_pad="
            f"{r['e_pad']:,} ({r['e_pad'] / max(r['e'], 1) - 1:.1%} "
            f"padding) tiles {r['n_tiles']:,}, F 64 f32: "
            + f"forward and backward bit-equal to seg_matmul_plain in "
            f"blocks {r['checked']} of {r['n_blocks']:,} (message elements "
            f"up to offset {r['top_elem']:,}), "
            + f"{r['launches']} K3 launches; K3 ms={r['ms']:.4f} (a launch"
            f", events) bound_ms={r['bound_ms']:.4f} (bytes) gather ms="
            f"{r['gather_ms']:.4f} index_add_ ms={r['library_ms']:.4f} (E "
            f"unpadded messages; events, zeroing included); K3 workspace "
            f"{r['ws_bytes'] / 1e9:.3f} GB")


def gnn_phase():
    """Phase 3i: the GNN family (gin-tu) on the card; returns K3's GNN
    numbers for the kernels line.

    (a) ``gnn_vs_host``. (b) ``agg_vs_plain`` at ``full_graph_sm``
    (Cora's 2,708 nodes and 10,556 seeded random edges), at
    ogb_products (c's graph; the first and the last ``GNN_CHECK_BLOCKS``
    blocks held to the plain version), at one ``minibatch_lg`` sampled
    block (d's first sample) and at one molecule batch (e's first). (c)
    ``for_shape(ogb_products)`` full-graph training (``node_loss``) on a
    seeded random graph with the published counts (2,449,029 nodes,
    61,859,140 edges, d_feat 100, 47 classes), 5 steps: layouts built on
    the card, median step ms (CUDA events, steps 2-5) against the bound
    (3 x ``gnn_full_train``'s model flops over 67 TFLOP/s f32, or one
    gathered 256 B row an edge an aggregation, 10 aggregations, over
    3.35 TB/s), peak ``max_memory_allocated``, K3 launches a step, a
    profiled step's device time by kernel, K3's and ``index_add_``'s
    device ms at that shape, the losses. (d) ``minibatch_lg``: a seeded
    Reddit-sized graph (232,965 nodes, 114,615,892 edges, lognormal
    degrees; the table keeps ``GNN_MAX_DEG`` neighbors a node), a fresh
    1,024-seed (15, 10) sample on the card each step, sharing the first
    sample's edges and layouts: sampler ms and step ms. (e)
    ``molecule``: 128 padded graphs of 30 nodes and 64 edges, a fresh
    batch each step, its layouts built before its step. (f) ``python -m
    repro_torch.launch.train --arch gin-tu`` on the card, a checkpoint,
    then ``--resume``."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="smoke_3i_")
    try:
        return _gnn_phase(tmp)
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _step_ms(dev, fn):
    """(fn's result, its ms by CUDA events)."""
    import torch
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize(dev)
    return out, a.elapsed_time(b)


def _gnn_phase(tmp, dev=None):
    import os
    import statistics

    import torch
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.gin_tu import for_shape
    from repro_torch.graph import (Graph, SamplerTables, khop_sizes,
                                   sample_khop)
    from repro_torch.kernels import counters, reset_counters
    from repro_torch.configs import get_spec
    from repro_torch.kernels.ops import EdgeLayouts, GNN_TILE_E
    from repro_torch.launch.steps import gnn_full_train
    from repro_torch.models import gnn as pg
    from repro_torch.train import (AdamWConfig, init_opt_state,
                                   make_train_step)
    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)

    # ------------------------------------- (a) card against the host CPU
    line, bad = gnn_vs_host(dev)
    print(line, flush=True)
    check(not bad, f"3i (a): {bad}")

    # ------------------------------------- (b) the aggregation at Cora
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sm = GNN_SHAPES["full_graph_sm"]
    src, dst = (torch.randint(0, sm["n_nodes"], (sm["n_edges"],),
                              generator=gen, device=dev, dtype=torch.int32)
                for _ in range(2))
    print(agg_line("full_graph_sm", agg_vs_plain(dev, src, dst,
                                                 sm["n_nodes"])), flush=True)

    # ---------------------------- (c) ogb_products full-graph training
    shape = GNN_SHAPES["ogb_products"]
    cfg = for_shape(shape)
    n, e = shape["n_nodes"], shape["n_edges"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    src, dst = (torch.randint(0, n, (e,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2))
    batch = {"x": torch.randn((n, cfg.d_in), generator=gen, device=dev),
             "src": src, "dst": dst,
             "labels": torch.randint(0, cfg.n_classes, (n,), generator=gen,
                                     device=dev)}
    lay, t_build = _step_ms(dev, lambda: EdgeLayouts.build(src, dst, n))
    batch["lay"] = lay
    fw = lay.fwd
    from repro_torch.kernels.seg_matmul import seg_scratch_sizes
    ws = seg_scratch_sizes(fw.blkid.shape[0], fw.n_blocks, fw.bs,
                           cfg.d_hidden, 4)[0]
    e_pad = fw.rows.shape[0]
    print(f"[3i ogb_products layouts] N={n:,} E={e:,} seeded random "
          f"(published counts), tile_e {GNN_TILE_E}: {fw.n_blocks:,} "
          f"blocks, {fw.blkid.shape[0]:,} tiles, e_pad {e_pad:,} "
          f"({e_pad / e - 1:.1%} padding); both layouts built on the card "
          f"in {t_build:.1f} ms; per aggregation: gathered messages "
          f"{e_pad * cfg.d_hidden * 4 / 1e9:.2f} GB, K3 workspace "
          f"{ws / 1e9:.2f} GB (one, shared by both layouts), index arrays "
          f"{4 * 4 * e_pad / 1e9:.2f} GB a layout", flush=True)
    model = pg.GIN(cfg, seed=SEED, device=dev)
    fn = lambda m, b: pg.node_loss(m, b, cfg)  # noqa: E731
    step = make_train_step(fn, AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=GNN_STEPS))
    st = init_opt_state(model)
    times, losses, per_step = [], [], []
    for _ in range(GNN_STEPS):
        reset_counters()
        (_, st, m), t = _step_ms(dev, lambda: step(model, st, batch))
        per_step.append(counters.seg_matmul)
        times.append(t)
        losses.append(float(m["loss"]))
    check(all(c == 2 * cfg.n_layers for c in per_step),
          f"3i (c): K3 launches a step {per_step}, not {2 * cfg.n_layers}")
    check(all(np.isfinite(losses)), f"3i (c): losses {losses}")
    peak = torch.cuda.max_memory_allocated(dev)
    dh = cfg.d_hidden
    # the model FLOPs of a step (forward + 2x backward), as the dry-run
    # counts them
    mf = gnn_full_train(get_spec("gin-tu"), shape).meta[
        "model_flops_per_step"] / 3
    t_ops = 3 * mf / PEAK_FLOPS["float32"] * 1e3
    t_bytes = 2 * cfg.n_layers * e * dh * 4 / HBM_BYTES_PER_S * 1e3
    med = statistics.median(times[1:])
    # one profiled step: the device time by kernel
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, t_prof = _step_ms(dev, lambda: step(model, st, batch))
    def dev_ms(ev):
        t = getattr(ev, "self_device_time_total", None)
        return (t if t is not None else ev.self_cuda_time_total) / 1e3
    kern = sorted(((ev.key, dev_ms(ev), ev.count)
                   for ev in prof.key_averages()), key=lambda x: -x[1])
    busy = sum(k[1] for k in kern)
    # the profiler drops kernel events late in a long process: say so
    seen = sum(k[2] for k in kern if "seg_matmul_kernel" in k[0])
    print(f"[3i train ogb_products] gin-tu for_shape(ogb_products) (5 "
          f"layers, d_hidden 64, d_in 100, 47 classes), node_loss, "
          f"{GNN_STEPS} steps: step ms {[round(t, 3) for t in times]} "
          f"(CUDA events), median of steps 2-{GNN_STEPS} {med:.3f}; bound "
          f"{max(t_ops, t_bytes):.3f} ms "
          f"({'operations' if t_ops > t_bytes else 'bytes'}: "
          f"flops {t_ops:.3f} ms = 3 x {mf / 1e9:.1f} GFLOP over 67 "
          f"TFLOP/s f32, bytes {t_bytes:.3f} ms = 10 aggregations x E x "
          f"256 B over 3.35 TB/s); peak allocated {peak / 1e9:.2f} GB; K3 "
          f"launches a step {per_step}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    print(f"[3i profile ogb_products] one step: {t_prof:.3f} ms (events), "
          f"the profiler saw {seen} of {2 * cfg.n_layers} K3 launches"
          + ("" if seen == 2 * cfg.n_layers else " (events dropped: the "
             "split below is incomplete)")
          + f"; device busy {busy:.3f} ms (idle share "
          f"{max(0.0, 1 - busy / t_prof):.3f}); top kernels (ms, count): "
          + "; ".join(f"{k[0][:48]} {k[1]:.3f} x{k[2]}" for k in kern[:8]),
          flush=True)
    c_launches = sum(per_step)
    del st, step, m
    torch.cuda.empty_cache()
    ogb = agg_vs_plain(dev, src, dst, n, lay=lay, blocks=GNN_CHECK_BLOCKS)
    print(agg_line("ogb_products", ogb), flush=True)
    del model, batch, src, dst, lay
    torch.cuda.empty_cache()

    # ------------------------------------------- (d) minibatch_lg
    shape = GNN_SHAPES["minibatch_lg"]
    cfg = for_shape(shape)
    n, e = shape["n_nodes"], shape["n_edges"]
    fan, nb = tuple(shape["fanout"]), shape["batch_nodes"]
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    wdeg = rng.lognormal(0.0, 1.0, n)
    deg = np.floor(wdeg / wdeg.sum() * e).astype(np.int64)
    deg[rng.permutation(n)[:e - int(deg.sum())]] += 1
    g = Graph(n, np.repeat(np.arange(n, dtype=np.int32), deg),
              rng.integers(0, n, e, dtype=np.int32))
    tables = SamplerTables.build(g, GNN_MAX_DEG, device=dev)
    t_tab = time.perf_counter() - t0
    kept = int(np.minimum(deg, GNN_MAX_DEG).sum())
    print(f"[3i minibatch_lg tables] N={n:,} E={e:,} seeded, lognormal "
          f"degrees (max {deg.max():,}, median {int(np.median(deg))}); "
          f"table cut to {GNN_MAX_DEG} neighbors a node: {kept:,} edges "
          f"kept ({1 - kept / e:.1%} cut), "
          f"{tables.nbr.numel() * 4 / 1e9:.2f} GB on the card; built in "
          f"{t_tab:.1f} s (host padded_neighbors + H2D)", flush=True)
    del g
    feats = torch.randn((n, cfg.d_in), generator=gen, device=dev)
    ylab = torch.randint(0, cfg.n_classes, (n,), generator=gen, device=dev)
    model = pg.GIN(cfg, seed=SEED, device=dev)
    fn = lambda m, b: pg.sampled_loss(m, b, cfg)  # noqa: E731
    step = make_train_step(fn, AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=GNN_STEPS))
    st = init_opt_state(model)
    t_samp, t_step, losses, per_step = [], [], [], []
    torch.cuda.reset_peak_memory_stats(dev)
    sub = None
    for s in range(GNN_STEPS):
        def sample():
            seeds = torch.randperm(n, generator=gen, device=dev)[:nb]
            return seeds, sample_khop(tables, seeds, fan, generator=gen,
                                      like=sub)
        (seeds, sub), t = _step_ms(dev, sample)
        b, t_f = _step_ms(dev, lambda: {
            "feats": feats[sub.nodes.long()], "edge_src": sub.edge_src,
            "edge_dst": sub.edge_dst, "edge_mask": sub.edge_mask,
            "labels": ylab[seeds], "n_seeds": sub.n_seeds, "lay": sub.lay})
        t_samp.append(t + t_f)
        if s == 0:
            blk = agg_vs_plain(dev, b["edge_src"], b["edge_dst"],
                               b["feats"].shape[0], w=b["edge_mask"],
                               lay=sub.lay)
            print(agg_line("minibatch_lg block", blk), flush=True)
        reset_counters()
        (_, st, m), t = _step_ms(dev, lambda: step(model, st, b))
        t_step.append(t)
        per_step.append(counters.seg_matmul)
        losses.append(float(m["loss"]))
    check(all(c == 2 * cfg.n_layers for c in per_step),
          f"3i (d): K3 launches a step {per_step}")
    check(all(np.isfinite(losses)), f"3i (d): losses {losses}")
    n_tot, e_tot = khop_sizes(nb, fan)
    print(f"[3i train minibatch_lg] gin-tu for_shape(minibatch_lg) (d_in "
          f"602, 41 classes), sampled_loss, {nb} seeds x fanouts {fan} "
          f"({n_tot:,} nodes, {e_tot:,} edges a sample), a fresh sample "
          f"on the card each step: sampler ms (events, with the feature "
          f"gather) {[round(t, 3) for t in t_samp]}, step ms "
          f"{[round(t, 3) for t in t_step]} (median of steps 2-"
          f"{GNN_STEPS} {statistics.median(t_step[1:]):.3f}; sample 1 "
          f"builds the layouts, later ones share them); peak allocated "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB; K3 "
          f"launches a step {per_step}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    del model, st, step, m, b, sub, tables, feats, ylab
    torch.cuda.empty_cache()

    # ----------------------------------------------- (e) molecule
    shape = GNN_SHAPES["molecule"]
    cfg = for_shape(shape)
    gb, n, e = shape["global_batch"], shape["n_nodes"], shape["n_edges"]
    model = pg.GIN(cfg, seed=SEED, device=dev)
    fn = lambda m, b: pg.graph_loss(m, b, cfg)  # noqa: E731
    step = make_train_step(fn, AdamWConfig(lr=1e-3, warmup_steps=1,
                                           total_steps=GNN_STEPS))
    st = init_opt_state(model)
    t_step, t_lay, losses, per_step = [], [], [], []
    for s in range(GNN_STEPS):
        n_real = torch.randint(n // 2, n + 1, (gb,), generator=gen,
                               device=dev)
        e_real = torch.randint(e // 2, e + 1, (gb,), generator=gen,
                               device=dev)
        def ends():
            return (torch.rand((gb, e), generator=gen, device=dev)
                    * n_real[:, None]).long()
        b = {"x": torch.randn((gb, n, cfg.d_in), generator=gen, device=dev),
             "src": ends(), "dst": ends(),
             "node_mask": torch.arange(n, device=dev)[None, :]
             < n_real[:, None],
             "edge_mask": torch.arange(e, device=dev)[None, :]
             < e_real[:, None],
             "labels": torch.randint(0, cfg.n_classes, (gb,), generator=gen,
                                     device=dev)}
        b["lay"], t = _step_ms(dev, lambda: EdgeLayouts.build(
            b["src"], b["dst"], n))
        t_lay.append(t)
        if s == 0:
            mol = agg_vs_plain(dev, b["src"], b["dst"], n,
                               w=b["edge_mask"].reshape(-1), lay=b["lay"])
            print(agg_line("molecule batch", mol), flush=True)
        reset_counters()
        (_, st, m), t = _step_ms(dev, lambda: step(model, st, b))
        t_step.append(t)
        per_step.append(counters.seg_matmul)
        losses.append(float(m["loss"]))
    check(all(c == 2 * cfg.n_layers for c in per_step),
          f"3i (e): K3 launches a step {per_step}")
    check(all(np.isfinite(losses)), f"3i (e): losses {losses}")
    print(f"[3i train molecule] gin-tu for_shape(molecule), graph_loss, "
          f"{gb} padded graphs of {n} nodes and {e} edges flattened into "
          f"one edge set, a fresh batch each step: step ms "
          f"{[round(t, 3) for t in t_step]} (events), its layouts' build "
          f"before it {[round(t, 3) for t in t_lay]} ms (events); K3 "
          f"launches a step {per_step}; losses "
          f"{[round(x, 4) for x in losses]}", flush=True)
    del model, st, step, m, b

    # --------------------------------- (f) launch.train on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), TMPDIR=tmp)
    args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gin-tu", "--ckpt", os.path.join(tmp, "ck"), "--ckpt-every",
            "20"]
    outs = []
    for extra in (["--steps", "40"], ["--steps", "50", "--resume"]):
        t0 = time.perf_counter()
        r = subprocess.run(args + extra, capture_output=True, text=True,
                           env=env, cwd=tmp, timeout=300)
        check(r.returncode == 0, f"3i (f) launch.train: {r.stderr[-3000:]}")
        outs.append((time.perf_counter() - t0, r.stdout))
    check("(CUDA events)" in outs[0][1] and "done: 40 steps" in outs[0][1]
          and "resumed from step 40" in outs[1][1]
          and "done: 10 steps" in outs[1][1],
          f"3i (f): {outs[0][1][-1500:]} {outs[1][1][-1500:]}")
    for (t, out), what in zip(outs, ("40 steps", "--resume to 50")):
        print(f"[3i launch.train gin-tu {what}] {t:.1f} s: "
              + " | ".join(x.strip() for x in out.splitlines()[-3:]),
              flush=True)
    print(f"[3i] phase 3i: {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return dict(launches=c_launches, ogb=ogb, step_ms=med,
                bound_ms=max(t_ops, t_bytes))


if __name__ == "__main__":
    main()
