#!/usr/bin/env python3
"""Where the device time of K1, K2 and K3 goes, on one NVIDIA card.

    python3 chip_ablation.py
    python3 chip_ablation.py --k2-only [--src DIR]
    python3 chip_ablation.py --gnn-only [--src DIR]
    python3 chip_ablation.py --decode-only [--src DIR]

Each kernel is timed beside variants of its own source with one phase cut
out. A variant is the source with a few lines replaced (``K1_VARIANTS``,
``K2_VARIANTS``, ``K3_VARIANTS``); it is built with the port's nvcc flags
into ``build/ablation/`` and swapped in for the kernel's library. A cut
variant computes wrong results by design: only its time is read. K1 and
K2 run at the main path's shape (the first batch's union of 8 britannica
queries, as in ``chip_smoke.py``), K3 on britannica's edges (bs 128,
tile_e 256). K1's and K3's times are device times per launch from the
profiler, each variant measured twice (in order, then in reverse order),
in one process on one card. K2's rows are per sweep: one sweep as the
graph's WHILE body (CUDA events around calls of 2N and N sweeps, the
difference over N), the same three kernels launched one by one from
Python (events, and the kernels' device time from the profiler), the
body with the epilogue cut (a variant whose epilogue only counts the
sweep and sets the WHILE condition), and the epilogue at rank_k 0 and 10
with its top-k cut, its merge cut, and without its last CTA (device
time).

``--k2-only`` times only K2, unchanged, at the main path's shape: a whole
``bsr_converge_cols`` call (f64, rank_k 0, tol 1e-10: CUDA events, and
the device time of its kernels and copies from the profiler), and the
sweep epilogue alone at rank_k 0 and 10 with the loop kept running (tol
-1, stable_sweeps and max_iter 1e9: device ms per epilogue, all its
kernels). ``--src`` takes the package from another checkout's ``src``
(its kernels build there), so an earlier commit can be timed beside this
one in one call, for example the parent unpacked with ``git archive``
into ``build/parent``:

    python3 chip_ablation.py --k2-only --src build/parent/src

``--gnn-only`` times the GNN aggregation's forward at ogb_products'
published counts (2,449,029 nodes, 61,859,140 seeded random edges, F 64
f32; CUDA events, the mean of 3 calls): the gather into K3's slots done
five bit-equal ways (``index_select`` by int32 rows, the port's, and by
int64 rows, advanced indexing, ``F.embedding``, ``index_select`` of the
rows viewed as 16-byte complex128 values), and one K3 launch at tile_e
256 (the port's) and 512 with its workspace.

``--decode-only`` times LM decoding as ``chip_smoke.py`` phase 3h (b)
serves it: deepseek-v2-236b (4 of 60 layers: MLA and MoE) and
mixtral-8x7b (16 of 32 layers: GQA, sliding window, MoE) at full width,
batch 8, prompt 64, 192 generated tokens, ``launch.serve.load`` and
``generate``; the median decode step (CUDA events) and the wall.
"""
import argparse
import ctypes
import importlib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "ablation"

# (variant, [(text of the source, its replacement), ...])
K1_VARIANTS = {
    "full": [],
    "launch only": [("  const int kk = blockIdx.x;\n",
                     "  const int kk = blockIdx.x;\n  if (kk >= 0) return;\n")],
    "loads only": [('  asm volatile("cp.async.wait_all;\\n");\n'
                    "  __syncthreads();\n",
                    '  asm volatile("cp.async.wait_all;\\n");\n'
                    "  __syncthreads();\n  if (kk >= 0) return;\n")],
    "no fold": [("    if (nb == 1) {\n", "    if (true) {\n"),
                ("  if (nb == 1) return;\n", "  return;\n")],
    "x*cin one value a load": [("  if (EV > 1 && v == VT && ",
                                "  if (false && v == VT && ")],
}
# K2's variants keep the WHILE condition's update, so a cut graph still
# ends after max_iter sweeps
K2_VARIANTS = {
    "full": [],
    "no epilogue": [
        ("  if (p.mode == 0 && !p.has_cond && p.ctl[0] == 0) return;\n"
         "  ep_count(p);\n"
         "  __shared__ double red[EP_THREADS * EC];\n"
         "  const int s = blockIdx.x",
         "  if (p.mode == 0) return;\n"
         "  __shared__ double red[EP_THREADS * EC];\n"
         "  const int s = blockIdx.x"),
        ("  __shared__ A den[EP_MAXV], dena[EP_MAXV];\n",
         "  __shared__ A den[EP_MAXV], dena[EP_MAXV];\n"
         "  if (p.mode == 0) {\n"
         "    if (blockIdx.x == 0 && threadIdx.x == 0) {\n"
         "      const int k1 = p.ctl[1] + 1, flag = k1 < p.max_iter;\n"
         "      p.ctl[1] = k1;\n"
         "      p.ctl[0] = flag;\n"
         "      if (p.has_cond) cudaGraphSetConditional(p.cond, flag);\n"
         "    }\n"
         "    return;\n"
         "  }\n")],
    "no top-k": [("  if (p.mode == 1 || p.rank_k == 0) return;\n",
                  "  return;\n"),
                 ("    if (p.rank_k > 0) {\n", "    if (false) {\n")],
    "no merge": [("    if (p.rank_k > 0) {\n", "    if (false) {\n")],
    # every CTA of (b) stops after writing its sums: no counter, no last
    # CTA, so the loop never stops; timed on the standalone epilogue only
    "no last CTA": [("  // one thread publishes the CTA's sums and counts it",
                     "  return;\n  // one thread publishes the CTA's sums "
                     "and counts it")],
}
K3_VARIANTS = {
    "full": [],
    "launch only": [("  const int k = blockIdx.x;\n",
                     "  const int k = blockIdx.x;\n  if (k >= 0) return;\n")],
    "loads and rank only": [("  cp_async_wait_all();  // the slab has landed\n"
                             "  __syncthreads();\n",
                             "  cp_async_wait_all();  // the slab has landed\n"
                             "  __syncthreads();\n  if (k >= 0) return;\n")],
    "no fold": [("      if (nt == 1) {\n", "      if (true) {\n"),
                ("  if (nt == 1) return;\n", "  return;\n")],
}


def build_variants(build, source, variants, tag=""):
    """{variant: its library path}, one nvcc per variant, all at once."""
    text = (build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(variants.items()):
        i = f"{tag}{i}"
        src = text
        for old, new in subs:
            if old not in src:
                sys.exit(f"FAIL: {source}.cu no longer holds the text that "
                         f"variant '{name}' replaces:\n{old}")
            src = src.replace(old, new)
        cu = OUT / f"{source}_{i}.cu"
        cu.write_text(src)
        lib = OUT / f"lib{source}_{i}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return jobs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k2-only", action="store_true",
                    help="time only a K2 call and its sweep epilogue")
    ap.add_argument("--gnn-only", action="store_true",
                    help="time only the GNN aggregation's gather and K3 "
                    "at ogb_products' counts")
    ap.add_argument("--decode-only", action="store_true",
                    help="time only the LM decode steps of phase 3h (b)")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch to time")
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, str(Path(opts.src).resolve()))
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.graph import paper_dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.kernels import ops as O
    from repro_torch.serve import (BsrSweepBackend, RankService,
                                   RankServiceConfig)
    from repro_torch.serve.pipeline import PipelineJob
    S = importlib.import_module("repro_torch.kernels.seg_matmul")

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    if opts.decode_only:
        decode_rows(torch, torch.device("cuda", 0), opts.src)
        return
    if opts.gnn_only:
        build.build_all()
        gnn_rows(torch, torch.device("cuda", 0))
        return
    if opts.k2_only:
        build.build_all()
        h0, ca, ch, m, plan = main_path_inputs(
            torch, paper_dataset("britannica", 1.0), RankService,
            RankServiceConfig, PipelineJob, BsrSweepBackend)
        loop_row(torch, K, profile, ProfilerActivity, plan, h0, ca, ch, m,
                 opts.src)
        epilogue_rows(torch, K, profile, ProfilerActivity, plan, h0, ca, ch,
                      m, opts.src)
        return
    jobs = {("bsr_spmm", n): j for n, j in build_variants(
        build, "bsr_spmm", K1_VARIANTS).items()}
    jobs.update({("seg_matmul", n): j for n, j in build_variants(
        build, "seg_matmul", K3_VARIANTS).items()})
    jobs.update({("k2", n): j for n, j in build_variants(
        build, "bsr_spmm", K2_VARIANTS, tag="k2_").items()})
    libs = {}
    for (source, name), (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"FAIL: nvcc for {source} '{name}':\n{log[-4000:]}")
        lib = ctypes.CDLL(str(path))
        (S._declare if source == "seg_matmul" else K._declare)(lib)
        libs[(source, name)] = lib

    def device_ms(cases, kernel, n=20):
        """Mean device ms per launch of ``kernel`` for each (fn, launches
        per call) of ``cases``, all in one profiler session: the kernel's
        launches in time order, split by case."""
        for fn, _ in cases:
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for fn, _ in cases:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
        evs = sorted((e for e in prof.events() if kernel in e.name
                      and e.self_device_time_total > 0),
                     key=lambda e: e.time_range.start)
        want = sum(n * k for _, k in cases)
        if len(evs) != want:
            sys.exit(f"FAIL: the profiler saw {len(evs)} launches of "
                     f"{kernel}, not {want}")
        out, i = [], 0
        for _, k in cases:
            out.append(sum(e.self_device_time_total
                           for e in evs[i:i + n * k]) / 1e3 / (n * k))
            i += n * k
        return out

    dev = torch.device("cuda", 0)
    g = paper_dataset("britannica", 1.0)
    h0, ca, ch, m, plan = main_path_inputs(torch, g, RankService,
                                           RankServiceConfig, PipelineJob,
                                           BsrSweepBackend)
    seg = O.build_tiled_segments(g.dst, g.n_nodes, bs=128, tile_e=256)
    ds = O.DeviceSegments.of(seg, dev)
    msgs = np.random.default_rng(3).standard_normal((g.n_edges, 64))

    cases = []
    for name, dt in (("float64", torch.float64), ("float32", torch.float32),
                     ("bfloat16", torch.bfloat16)):
        ops = [(o.blocks.to(dt), o.idx, o.row_ptr)
               for o in (plan.lt.operand, plan.lfwd.operand)]
        x, cin, mk = (t.to(dt) for t in (h0, ch, m))
        scr = K.Scratch(dev)
        # the two operators in turn (together larger than L2), as the loop
        cases.append(("bsr_spmm", f"K1 {name}", 2, lambda ops=ops, x=x,
                      cin=cin, mk=mk, scr=scr: [K.bsr_scaled_matvec(
                          *o, x, cin, bs=128, mask=mk, scratch=scr)
                          for o in ops]))
    for f, name in ((1, "float32"), (8, "float32"), (64, "float32"),
                    (8, "float64"), (8, "bfloat16")):
        mm = O.pad_messages(torch.from_numpy(msgs[:, :f]).to(
            dev, getattr(torch, name)), seg).contiguous()
        scr = K.Scratch(dev)
        cases.append(("seg_matmul", f"K3 F={f} {name}", 1,
                      lambda mm=mm, scr=scr: S.seg_matmul(
                          ds.blkid, mm, ds.off, ds.valid, ds.n_blocks,
                          bs=128, tile_ptr=ds.tile_ptr, scratch=scr)))
    times = {}
    for rnd in range(2):
        for source, variants in (("bsr_spmm", K1_VARIANTS),
                                 ("seg_matmul", K3_VARIANTS)):
            mine = [c for c in cases if c[0] == source]
            names = list(variants) if rnd == 0 else list(variants)[::-1]
            for name in names:
                build._libs[source] = libs[(source, name)]
                got = device_ms([(fn, k) for _, _, k, fn in mine],
                                f"{source}_kernel")
                for (_, case, _, _), t in zip(mine, got):
                    times.setdefault((case, name), []).append(t)
    for (case, name), ts in times.items():
        print(f"[{case}] {name}: device ms " + " ".join(f"{t:.4f}"
                                                        for t in ts))
    k2_rows(torch, K, build, libs, plan, h0, ca, ch, m, device_ms)


def decode_rows(torch, dev, src, b=8, prompt=64, gen=192):
    """Decode at full width as phase 3h (b): median step ms over the
    ``prompt + gen - 1`` steps (CUDA events) and the wall."""
    import dataclasses
    import statistics
    import time
    from repro_torch.configs import get_spec
    from repro_torch.launch import serve as lserve
    from repro_torch.launch.train import StepTimer
    for arch, n_layers in (("deepseek-v2-236b", 4), ("mixtral-8x7b", 16)):
        cfg = dataclasses.replace(get_spec(arch).config, n_layers=n_layers)
        model, cache, prompts = lserve.load(cfg, b, prompt, gen, device=dev)
        torch.cuda.synchronize(dev)
        timer = StepTimer(dev, warmup=0)
        t0 = time.perf_counter()
        out = lserve.generate(model, cache, prompts, gen, span=timer.span)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        steps = [a.elapsed_time(c) for a, c in timer.marks["step"]]
        if tuple(out.shape) != (b, gen):
            sys.exit(f"FAIL: {arch} generated {tuple(out.shape)}")
        print(f"[decode {arch}] src {src}: {n_layers} layers, batch {b}, "
              f"{len(steps)} steps: median step {statistics.median(steps):.3f}"
              f" ms (CUDA events), wall {wall:.3f} s", flush=True)
        del model, cache, prompts, out
        torch.cuda.empty_cache()


def gnn_rows(torch, dev, f=64):
    """``--gnn-only``: one line of the gather's ways and one of K3 at
    tile_e 256 and 512 (see the module docstring)."""
    import torch.nn.functional as F
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.kernels.ops import EdgeLayouts
    from repro_torch.kernels.seg_matmul import seg_matmul, seg_scratch_sizes

    def ms(fn, n=3):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize(dev)
        return a.elapsed_time(b) / n

    shape = GNN_SHAPES["ogb_products"]
    n, e = shape["n_nodes"], shape["n_edges"]
    gen = torch.Generator(device=dev).manual_seed(0)
    src, dst = (torch.randint(0, n, (e,), generator=gen, device=dev,
                              dtype=torch.int32) for _ in range(2))
    h = torch.randn((n, f), generator=gen, device=dev)
    lay = EdgeLayouts.build(src, dst, n)
    rows = lay.fwd.rows
    rows_l = rows.long()
    ref = h.index_select(0, rows)
    ways = {"index_select int32": lambda: h.index_select(0, rows),
            "index_select int64": lambda: h.index_select(0, rows_l),
            "h[rows]": lambda: h[rows_l],
            "F.embedding": lambda: F.embedding(rows_l, h),
            "complex128 view": lambda: h.view(torch.complex128)
            .index_select(0, rows).view(torch.float32)}
    out = []
    for name, fn in ways.items():
        if not torch.equal(fn(), ref):
            sys.exit(f"FAIL: gather {name} differs from index_select")
        out.append(f"{name} {ms(fn):.3f}")
    del ref, rows_l
    print(f"[gnn gather ogb_products N={n:,} E={e:,} F={f}] ms (events): "
          + "; ".join(out), flush=True)
    k3 = []
    for te in (256, 512):
        lt = lay if te == 256 else EdgeLayouts.build(src, dst, n, tile_e=te)
        fw = lt.fwd
        m = fw.messages(h)
        t = ms(lambda: seg_matmul(fw.blkid, m, fw.off, fw.valid, fw.n_blocks,
                                  bs=fw.bs, tile_ptr=fw.tile_ptr,
                                  scratch=lt.scratch))
        ws = seg_scratch_sizes(fw.blkid.shape[0], fw.n_blocks, fw.bs, f,
                               4)[0]
        k3.append(f"tile_e {te}: {t:.3f} ms, e_pad {fw.rows.shape[0]:,}, "
                  f"workspace {ws / 1e9:.2f} GB")
        del lt, fw, m
        torch.cuda.empty_cache()
    print("[gnn K3 ogb_products] a launch (events): " + "; ".join(k3),
          flush=True)


def main_path_inputs(torch, g, RankService, RankServiceConfig, PipelineJob,
                     BsrSweepBackend):
    """The first main-path batch (8 queries of 50 roots, seed 0, on
    britannica ``g``) planned by the bsr backend: (h0, ca, ch, mask, plan)
    on the card, in the plan's node order."""
    rng = np.random.default_rng(0)
    queries = [rng.choice(g.n_nodes, size=50, replace=False)
               for _ in range(8)]
    svc = RankService(g, RankServiceConfig(device="cuda", backend="bsr",
                                           v_max=8, dtype="float64"))
    batch = svc.pipeline.assemble(PipelineJob(
        queries=[svc.validate_roots(q) for q in queries])).batch
    plan = BsrSweepBackend(bs=128, device="cuda").plan(batch)
    dev = torch.device("cuda", 0)
    h0, ca, ch, m = (torch.from_numpy(x).to(dev).index_select(
        0, plan.perm_dev).contiguous() for x in (batch.h0, batch.ca, batch.ch,
                                                 batch.mask))
    return h0, ca, ch, m, plan


def loop_row(torch, K, profile, ProfilerActivity, plan, h0, ca, ch, m,
             label, n=10):
    """One K2 call of the package in use at the main path's shape (f64,
    rank_k 0, tol 1e-10, max_iter 1000): ms per call from CUDA events
    around n calls after two warm-up calls, and the device time of every
    kernel and copy of a call from the profiler."""
    lt, lf = plan.lt.operand, plan.lfwd.operand

    def call():
        return K.bsr_converge_cols(lt, lf, h0, ca, ch, m, 1e-10, bs=plan.bs,
                                   max_iter=1000, rank_k=0, stable_sweeps=2)
    out = call()
    call()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(n):
        call()
    b.record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.events()
                 if e.self_device_time_total > 0)
    print(f"[K2 call, {label}] f64 rank_k 0: {int(out[2].max())} sweeps, "
          f"ms per call {a.elapsed_time(b) / n:.4f} (events), device ms "
          f"{dev_us / 1e3 / n:.4f}", flush=True)


def epilogue_rows(torch, K, profile, ProfilerActivity, plan, h0, ca, ch, m,
                  label, n=50):
    """The sweep epilogue of the package in use at the main path's shape,
    rank_k 0 and 10, the loop kept running: device ms per epilogue (every
    kernel whose name holds "ep_": this tree's ep_slice/ep_finish, an
    earlier tree's sweep_epilogue_kernel) over n calls."""
    lt, lf = plan.lt.operand, plan.lfwd.operand
    a = K.bsr_scaled_matvec(*lt, h0, ch, bs=plan.bs, mask=m)
    hr = K.bsr_scaled_matvec(*lf, a, ca, bs=plan.bs, mask=m)
    for rk in (0, 10):
        # three entries: an earlier tree's loop state has three, this
        # tree's reads the first two
        st = K.LoopState.start(torch.zeros(3, dtype=torch.int32,
                                           device=h0.device),
                               h0.shape[1], rk, 10 ** 9)
        h = h0.clone()

        def epi():
            K.sweep_epilogue(hr, h, a, st, tol=-1.0, stable_sweeps=10 ** 9,
                             max_iter=10 ** 9)
        epi()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                epi()
            torch.cuda.synchronize()
        evs = [e for e in prof.events()
               if "ep_" in e.name and e.self_device_time_total > 0]
        if int(st.ctl[0]) != 1 or not evs:
            sys.exit(f"FAIL: epilogue rank_k={rk}: the loop stopped or the "
                     "profiler saw no epilogue kernel")
        names = sorted({re.search(r"(\w+_kernel)", e.name).group(1)
                        for e in evs})
        # per epilogue: the mean kernel time times the kernels it launches
        # (a record the profiler drops does not bias it)
        us = sum(e.self_device_time_total for e in evs) / len(evs) \
            * len(names)
        print(f"[epilogue only, {label}] rank_k={rk}: device ms per epilogue "
              f"{us / 1e3:.4f} ({len(evs)} launches of {', '.join(names)} "
              f"over {n} epilogues)", flush=True)


def k2_rows(torch, K, build, libs, plan, h0, ca, ch, m, device_ms, n=10):
    """K2 per sweep at the main path's shape (f64, V 8): as the graph's
    WHILE body, as three eager launches, with the epilogue cut; and the
    epilogue at rank_k 10 with and without its top-k."""
    lt, lf = plan.lt.operand, plan.lfwd.operand

    def events(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    def body_ms(variant):
        """ms per sweep of the graph body: an unreachable tol runs exactly
        max_iter sweeps; calls of 2n and n sweeps differ by n bodies."""
        build._libs["bsr_spmm"] = libs[("k2", variant)]
        t = {it: events(lambda it=it: K.bsr_converge_cols(
            lt, lf, h0, ca, ch, m, -1.0, bs=plan.bs, max_iter=it))
            for it in (n, 2 * n)}
        return (t[2 * n] - t[n]) / n

    for rnd in range(2):
        for variant in (("full", "no epilogue") if rnd == 0
                        else ("no epilogue", "full")):
            print(f"[K2 f64 sweep] graph body, {variant}: ms per sweep "
                  f"{body_ms(variant):.4f} (events)", flush=True)
    build._libs["bsr_spmm"] = libs[("k2", "full")]
    st = K.LoopState.start(torch.zeros(2, dtype=torch.int32, device=h0.device),
                           h0.shape[1], 0, 10 ** 9)
    h, a, hr = h0.clone(), torch.empty_like(h0), torch.empty_like(h0)
    scr = K.Scratch(h0.device)

    def eager():
        K._launch_spmm(lt, h, ch, plan.bs, None, m, a, scratch=scr)
        K._launch_spmm(lf, a, ca, plan.bs, None, m, hr, scratch=scr)
        K.sweep_epilogue(hr, h, a, st, tol=-1.0, stable_sweeps=2,
                         max_iter=10 ** 9)
    # one sweep launched from Python, as a loop without the graph would
    print(f"[K2 f64 sweep] three eager launches: ms per sweep "
          f"{events(eager, 20):.4f} (events); device ms "
          f"{device_ms([(eager, 2)], 'bsr_spmm_kernel')[0] * 2:.4f} (K1 x 2) + "
          f"{device_ms([(eager, 2)], 'ep_')[0] * 2:.4f} (epilogue)",
          flush=True)
    a10 = K.bsr_scaled_matvec(*lt, h0, ch, bs=plan.bs, mask=m)
    hr10 = K.bsr_scaled_matvec(*lf, a10, ca, bs=plan.bs, mask=m)
    variants = ["full", "no top-k", "no merge", "no last CTA"]
    for rnd in range(2):
        for variant in variants if rnd == 0 else variants[::-1]:
            build._libs["bsr_spmm"] = libs[("k2", variant)]
            for rk in (0, 10):
                st = K.LoopState.start(torch.zeros(2, dtype=torch.int32,
                                                   device=h0.device),
                                       h0.shape[1], rk, 10 ** 9)
                hh = h0.clone()
                t = device_ms([(lambda: K.sweep_epilogue(
                    hr10, hh, a10, st, tol=-1.0, stable_sweeps=10 ** 9,
                    max_iter=10 ** 9), 2)], "ep_")[0] * 2
                print(f"[epilogue rank_k={rk}] {variant}: device ms {t:.4f} "
                      "(both kernels)", flush=True)
    build._libs["bsr_spmm"] = libs[("k2", "full")]


if __name__ == "__main__":
    main()
