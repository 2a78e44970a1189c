#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

0. the card's name and power limit (``nvidia-smi``); build the CUDA kernels
   from ``src/repro_torch/kernels/csrc`` and print the build time and the
   compiler's register/spill report;
1. K1 (``bsr_scaled_matvec``) against its plain torch version on the card,
   at the main path's shape (the britannica union of 8 queries of 50 roots:
   n_pad 4096, bs 128, V 8) in f64, f32 and bf16, plus bs 16 and V 1; time
   per launch beside the bound and a PyTorch yardstick (``library_ms``);
2. the sweep epilogue and K2 (``bsr_converge_cols``) against their plain
   versions on the card: rank_k 0 and 10, ladder off and bf16;
3. the main path: ``RankService.rank`` on ``paper_dataset("britannica")``
   with the ``bsr`` backend on the card, 3 batches of 8 seeded queries of 50
   roots, a repeat batch served from cache, then a rank_k=10 service and a
   bf16-ladder service; every query is held to the same service on the CPU,
   and the launch counters (zeroed just before each run) must show K1, the
   epilogue and K2 ran;
4. a ``{"kernels": [...]}`` line, then the contract's last line.

It imports torch, numpy and the port only. Times come from CUDA events over
repeated launches after a warm-up; bounds are computed from this run's
inputs against the H100 SXM data-sheet peaks below.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# peak rate per operand type: bf16 dense tensor cores and f32 outside the
# tensor cores; f64 tensor cores (H100 SXM data sheet)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "float64": 67e12}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def main():
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        fail(f"{ROOT} is not a checkout of the repo (src/repro_torch missing)")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import bsr_spmm as K
    from repro_torch.serve import (BsrSweepBackend, RankService,
                                   RankServiceConfig)
    from repro_torch.serve.pipeline import PipelineJob
    from repro_torch.graph import paper_dataset

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
    for line in build.ptxas_report("bsr_spmm").splitlines():
        if "registers" in line or "spill" in line:
            print("[ptxas]", line.strip())

    def ms(fn, n):
        """Mean ms per call of fn over n calls after two warm-up calls."""
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
    print(f"[main-path shape] union n_pad={n_pad} V={v} bs={plan.bs} "
          f"blocks Lt={nblk[0]} L={nblk[1]} "
          f"({nbytes(lt.blocks) / 1e6:.1f} MB per f64 operator)", flush=True)
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
        y = K.bsr_scaled_matvec(*ops[0], x, cin, bs=plan.bs, mask=mk)
        yp = K.bsr_scaled_matvec_plain(*ops[0], x, cin, bs=plan.bs, mask=mk)
        torch.cuda.synchronize()
        err = (y.double() - yp.double()).abs().max().item()
        scale = yp.double().abs().max().item()
        check(err <= tol_k1[name] * scale,
              f"K1 {name}: max|y - plain| = {err:.3e} > "
              f"{tol_k1[name]:.1e} * {scale:.3e}")
        # the loop alternates Lᵀ and L (together larger than L2): time pairs
        kern = lambda: [K.bsr_scaled_matvec(*o, x, cin, bs=plan.bs, mask=mk)  # noqa: E731
                        for o in ops]
        plain = lambda: [K.bsr_scaled_matvec_plain(*o, x, cin, bs=plan.bs,  # noqa: E731
                                                   mask=mk) for o in ops]
        t_k = ms(kern, 20) / 2
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
        k1[name] = dict(err=err, ms=t_k, plain_ms=t_p, library_ms=t_lib,
                        bound_ms=max(t_bytes, t_ops),
                        bound_by="bytes" if t_bytes >= t_ops else "operations")
        print(f"[K1 {name}] max_abs_err={err:.3e} ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} library_ms={t_lib:.4f} ({lib_kind}) "
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
            ctl = torch.zeros(3, dtype=torch.int32, device=dev)
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
        # tol -1 and a large max_iter keep the flag set across repeats
        st = K.LoopState.start(torch.zeros(3, dtype=torch.int32, device=dev),
                               v, rk, 10 ** 9)
        hk = h0.clone()
        t_k = ms(lambda: K.sweep_epilogue(hr, hk, a, st, tol=-1.0,
                                          stable_sweeps=2,
                                          max_iter=10 ** 9), 50)
        st_p = K.LoopState.start(torch.zeros(3, dtype=torch.int32,
                                             device=dev), v, rk, 10 ** 9)
        hp = h0.clone()
        t_p = ms(lambda: K.sweep_epilogue_plain(hr, hp, a, st_p, tol=-1.0,
                                                stable_sweeps=2,
                                                max_iter=10 ** 9), 5)
        moved = nbytes(hr, hk, hk) + (nbytes(a) if rk else 0)
        ep[rk] = dict(err=err, ms=t_k, plain_ms=t_p,
                      bound_ms=moved / HBM_BYTES_PER_S * 1e3)
        print(f"[epilogue rank_k={rk}] max_abs_err={err:.3e} ms={t_k:.4f} "
              f"plain_ms={t_p:.4f} bound_ms={ep[rk]['bound_ms']:.5f}",
              flush=True)

    lo = {o: K.BsrOperand(getattr(plan, o).blocks.to(torch.bfloat16),
                          getattr(plan, o).idx, getattr(plan, o).row_ptr)
          for o in ("lt", "lfwd")}
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
            syncs = K.counters.host_syncs
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
            phases = 2 if bulk else 1
            check(syncs <= math.ceil(sweeps / K.CHUNK) + phases,
                  f"K2: {syncs} host syncs for {sweeps} sweeps")
            entry = dict(err=max(dh, da), sweeps=sweeps, syncs=syncs)
            if rk == 0 and bulk is None:
                entry["ms"] = ms(lambda: K.bsr_converge_cols(
                    lt, lf, h0, ca, ch, m, 1e-10, **kw), 3)
                entry["plain_ms"] = ms(lambda: K.bsr_converge_cols_plain(
                    lt, lf, h0, ca, ch, m, 1e-10, **kw), 1)
                op_bytes = nbytes(*lt) + nbytes(*lf)
                t_bytes = (op_bytes + nbytes(h0, ca, ch, m) * 1.5) \
                    / HBM_BYTES_PER_S * 1e3
                t_ops = (sweeps + 1) * 2.0 * sum(nblk) * plan.bs ** 2 * v \
                    / PEAK_FLOPS["float64"] * 1e3
                entry["bound_ms"] = max(t_bytes, t_ops)
                entry["bound_by"] = "bytes" if t_bytes >= t_ops \
                    else "operations"
                entry["reread_ms"] = (sweeps + 1) * op_bytes \
                    / HBM_BYTES_PER_S * 1e3
            k2[(rk, bulk)] = entry
            print(f"[K2 rank_k={rk} ladder={bulk}] sweeps={sweeps} "
                  f"host_syncs={syncs} conv={out[2].tolist()} "
                  f"L1 h={dh:.2e} a={da:.2e}"
                  + (f" ms={entry['ms']:.3f} plain_ms={entry['plain_ms']:.3f}"
                     f" bound_ms={entry['bound_ms']:.4f} "
                     f"(operators re-read every sweep: "
                     f"{entry['reread_ms']:.4f})" if "ms" in entry else ""),
                  flush=True)

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
        check(counts["bsr_spmm"] > 0 and counts["sweep_epilogue"] > 0
              and counts["bsr_converge"] == 3,
              f"{label}: the main path did not run the kernels: {counts}")
        sync_cap = sum(math.ceil(s / K.CHUNK) + 2 for s in per_batch)
        check(counts["host_syncs"] <= sync_cap,
              f"{label}: {counts['host_syncs']} host syncs > {sync_cap}")
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
    from torch.profiler import ProfilerActivity, profile
    fresh = RankService(g, RankServiceConfig(device="cuda", **cfg))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fresh.rank(queries)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    dev_us = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t:
            dev_us[e.key] = t
    busy = sum(dev_us.values()) / 1e3
    if busy:
        top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:6]
        print(f"[main f64 profile] device busy {busy:.2f} ms of "
              f"{wall_prof * 1e3:.1f} ms wall (idle share "
              f"{1 - busy / (wall_prof * 1e3):.3f}); by device time: "
              + "; ".join(f"{k[:48]} {v / 1e3:.2f} ms" for k, v in top))
    else:
        print("[main f64 profile] the profiler reported no device time: "
              "device busy share not measured")
    K.reset_counters()
    again = svc.rank(queries[:8])
    check(all(r.status == "hit" for r in again) and
          K.counters.bsr_spmm == 0, "repeat batch was not served from cache")
    print("[main f64] repeat batch: 8/8 cache hits, no kernel launched")
    serve({"rank_k": 10}, "rank_k=10")
    serve({"sweep_dtype": "bf16"}, "bf16 ladder")

    # ---------------------------------------------------- 4. result lines
    kernels = [
        dict(name="bsr_spmm", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:44",
             launches=counts["bsr_spmm"], max_abs_err=k1["float64"]["err"],
             ms=k1["float64"]["ms"], plain_ms=k1["float64"]["plain_ms"],
             bound_ms=k1["float64"]["bound_ms"],
             bound_by=k1["float64"]["bound_by"],
             library_ms=k1["float64"]["library_ms"]),
        dict(name="sweep_epilogue", route="cuda",
             source="src/repro_torch/kernels/csrc/bsr_spmm.cu",
             replaces="src/repro/kernels/bsr_spmm.py:179",
             launches=counts["sweep_epilogue"], max_abs_err=ep[0]["err"],
             ms=ep[0]["ms"], plain_ms=ep[0]["plain_ms"],
             bound_ms=ep[0]["bound_ms"], bound_by="bytes", library_ms=None),
        dict(name="bsr_converge_cols", route="cuda",
             source="src/repro_torch/kernels/bsr_spmm.py",
             replaces="src/repro/kernels/bsr_spmm.py:117",
             launches=counts["bsr_converge"],
             max_abs_err=max(e["err"] for e in k2.values()),
             ms=k2[(0, None)]["ms"], plain_ms=k2[(0, None)]["plain_ms"],
             bound_ms=k2[(0, None)]["bound_ms"],
             bound_by=k2[(0, None)]["bound_by"], library_ms=None),
    ]
    print(f"[total] {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
