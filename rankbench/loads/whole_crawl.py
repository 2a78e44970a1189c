"""Whole-crawl ranking: the paper's accelerated HITS over the whole crawl,
on the port's K1 path (``repro_torch.kernels.ops.hits_sweep_bsr`` under
``repro_torch.core.power.power_method``), rankings run back to back.

One ranking runs from the uniform start until the hub's L1 change is at
most the configuration's ``tol`` and reads the hub and authority vectors
back to the host. The operators are built once in set-up, from the
configuration's crawl numbered by the seed, with Ca/Ch from the port's
``core.weights.accel_weights``: the window re-ranks one unchanged crawl,
and the build, which a changed crawl pays again, is timed on its own
(``operators_s.crawl``). Every ranking of the window is held to
the reference's ranking of the same edges.
"""
from __future__ import annotations

import time

import numpy as np

from rankbench import reference, webgraph


class Load:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str,
                 control: bool = False, scale: float = 1.0):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = device
        rk = cfg["ranking"]
        # the control: the program's own float32 path (K1 in float32)
        self.dtype = "float32" if control else rk["dtype"]
        self.tol, self.max_iter = float(rk["tol"]), int(rk["max_iter"])
        self.scale = scale
        self.results = []     # distinct (hub, authority, sweeps, count)
        self.sweeps = []      # sweeps of each ranking of the window
        self.elapsed = 0.0
        self.attempted = 0
        self.failed = 0
        self.phases = {}      # set-up seconds by step

    def setup(self):
        import torch
        from repro_torch.core.weights import accel_weights
        from repro_torch.graph.structure import Graph
        from repro_torch.kernels import ops
        from repro_torch.runtime import torch_dtype
        t0 = time.perf_counter()
        self.n, self.src, self.dst = webgraph.crawl(self.cfg, self.seed,
                                                    self.scale)
        t1 = time.perf_counter()
        g = Graph(self.n, self.src, self.dst)
        ca, ch = accel_weights(g.indeg(), g.outdeg())
        self.sweep, self.lt, self.l = ops.hits_sweep_bsr(
            g, ca, ch, bs=self.cfg["block"], dtype=self.dtype,
            device=self.device)
        self.h0 = torch.full((self.n,), 1.0 / self.n,
                             dtype=torch_dtype(self.dtype),
                             device=self.device)
        if self.device != "cpu":
            torch.cuda.synchronize()
        t2 = time.perf_counter()
        self._rank()  # loads K1 and sizes its workspaces
        self.phases = {"crawl": t1 - t0, "operators": t2 - t1,
                       "first ranking": time.perf_counter() - t2}

    def _rank(self):
        from repro_torch.core import power
        r = power.power_method(self.sweep, self.h0, tol=self.tol,
                               max_iter=self.max_iter)
        return r.v, r.aux, int(r.iters)

    def _keep(self, hub, auth, sweeps):
        for r in self.results:
            if r[2] == sweeps and np.array_equal(r[0], hub) \
                    and np.array_equal(r[1], auth):
                r[3] += 1
                return
        self.results.append([hub, auth, sweeps, 1])

    def window(self, seconds: float, tracer):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with tracer.span("crawl.ranking"):
                hub, auth, sweeps = self._rank()
            self._keep(hub, auth, sweeps)
            self.sweeps.append(sweeps)
            now = time.perf_counter()
            if now >= deadline:
                break
        self.elapsed = now - t0
        self.attempted = len(self.sweeps)

    def end_to_end(self) -> dict:
        return {"crawl_rank_ms": self.elapsed * 1e3 / len(self.sweeps)}

    def observations(self) -> dict:
        return {"crawl": {"pages": self.n, "links": int(len(self.src)),
                          "dtype": self.dtype, "sweeps": list(self.sweeps),
                          "operators_s": self.phases["operators"]}}

    def release(self):
        import torch
        del self.sweep, self.lt, self.l, self.h0
        if self.device != "cpu":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Every distinct answer of the window against the reference: the
        gap in sweeps, and the L1 gaps of the hub and of the authority
        (each L1-normalised), the worst of each over the answers."""
        hub_r, auth_r, sweeps_r = reference.crawl_ranking(
            self.n, self.src, self.dst, self.tol, self.max_iter)
        lim = self.traffic["limits"]
        worst = {k: 0.0 for k in lim}
        for hub, auth, sweeps, count in self.results:
            auth = auth / (np.abs(auth).sum() + 1e-30)
            got = {"sweeps_gap": float(abs(sweeps - sweeps_r)),
                   "hub_l1": float(np.abs(hub - hub_r).sum()),
                   "authority_l1": float(np.abs(auth - auth_r).sum())}
            if any(got[k] > lim[k] for k in lim):
                self.failed += count
            for k in lim:
                worst[k] = max(worst[k], got[k])
        return {k: {"value": worst[k], "limit": lim[k]} for k in lim}
