#!/usr/bin/env python3
"""Where the device time of K1 and K3 goes, on one NVIDIA card.

    python3 chip_ablation.py

Each kernel is timed beside variants of its own source with one phase cut
out. A variant is the source with a few lines replaced (``K1_VARIANTS``,
``K3_VARIANTS``); it is built with the port's nvcc flags into
``build/ablation/`` and swapped in for the kernel's library. A cut variant
computes wrong results by design: only its time is read. K1 runs at the
main path's shape (the first batch's union of 8 britannica queries, as in
``chip_smoke.py``), K3 on britannica's edges (bs 128, tile_e 256). Times are
device times per launch from the profiler, each variant measured twice
(in order, then in reverse order), in one process on one card.
"""
import ctypes
import importlib
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


def build_variants(build, source, variants):
    """{variant: its library path}, one nvcc per variant, all at once."""
    text = (build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for i, (name, subs) in enumerate(variants.items()):
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
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAIL: torch.cuda.is_available() is False: this needs a card")
    sys.path.insert(0, str(ROOT / "src"))
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
    jobs = {("bsr_spmm", n): j for n, j in build_variants(
        build, "bsr_spmm", K1_VARIANTS).items()}
    jobs.update({("seg_matmul", n): j for n, j in build_variants(
        build, "seg_matmul", K3_VARIANTS).items()})
    libs = {}
    for (source, name), (path, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"FAIL: nvcc for {source} '{name}':\n{log[-4000:]}")
        lib = ctypes.CDLL(str(path))
        (K._declare if source == "bsr_spmm" else S._declare)(lib)
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
    rng = np.random.default_rng(0)
    queries = [rng.choice(g.n_nodes, size=50, replace=False)
               for _ in range(8)]
    svc = RankService(g, RankServiceConfig(device="cuda", backend="bsr",
                                           v_max=8, dtype="float64"))
    batch = svc.pipeline.assemble(PipelineJob(
        queries=[svc.validate_roots(q) for q in queries])).batch
    plan = BsrSweepBackend(bs=128, device="cuda").plan(batch)
    h0, ch, m = (torch.from_numpy(x).to(dev).index_select(0, plan.perm_dev)
                 .contiguous() for x in (batch.h0, batch.ch, batch.mask))
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


if __name__ == "__main__":
    main()
