"""Training launcher (port of ``repro.launch.train``, on the card unless
``--device cpu``): an LM, GNN or recsys ``--arch`` with
checkpoint/restart.
Every flag is the reference's, plus ``--device``. A checkpoint holds
``{"params": <the reference's parameter tree>, "opt": {"m", "v",
"step"}}`` with the reference's keys, so a checkpoint directory written
by either package resumes in the other.

  PYTHONPATH=src python -m repro_torch.launch.train --arch dlrm-rm2 \
      --steps 20 --batch 65536
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch deepseek-7b --smoke --steps 50 --batch 8 --seq 64 \
      --ckpt /tmp/lm_ckpt

An LM arch trains the ``Transformer`` on ``lm_batch`` (``--seq`` tokens a
row). The GNN (``gin-tu``) trains ``GIN`` by ``node_loss`` on the
reference's graph (``generate_webgraph(WebGraphSpec(500, 4000, 0.2,
seed=1))``) with features and labels from a seeded ``torch.Generator``
(not ``jax.random``'s bits), one batch kept on the device for every
step and its aggregation layouts built once beside it; ``--batch`` and
``--seq`` do not apply and its samples are the graph's nodes. Besides
the reference's lines it
prints a ``timing:`` line over the steps after the first two
(``StepTimer``): the median step time (CUDA events on the card, the
host clock on the CPU), the wall time a step with the host's batch
build and its copy to the device included, samples per second over that
wall, the medians of the batch build and of the copy, and the peak of
``torch.cuda.max_memory_allocated``.
"""
from __future__ import annotations

import argparse
import statistics
import time
from contextlib import contextmanager

import numpy as np
import torch


class StepTimer:
    """Times a training loop on ``dev``. Per step: the host's batch build
    (host clock), its copy to the device and the step (CUDA events on the
    card, the host clock on the CPU). The wall: the host clock over the
    steps after the first ``warmup``, from a synchronize before the first
    of them to one after the last, batch builds and copies included and
    the time inside ``excluded()`` (checkpoint saves) left out."""

    def __init__(self, dev, warmup: int = 2):
        self.dev, self.warmup = dev, warmup
        self.card = dev.type == "cuda"
        self.marks = {"build": [], "h2d": [], "step": []}
        self.t0 = None
        self.skip = 0.0

    def _sync(self):
        if self.card:
            torch.cuda.synchronize(self.dev)

    @contextmanager
    def span(self, kind: str):
        """One ``build``, ``h2d`` or ``step`` span of the current step."""
        if kind == "build" and self.t0 is None and \
                len(self.marks["step"]) == self.warmup:
            self._sync()
            self.t0 = time.perf_counter()
        if self.card and kind != "build":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
        else:
            a = time.perf_counter()
            yield
            b = time.perf_counter()
        self.marks[kind].append((a, b))

    @contextmanager
    def excluded(self):
        self._sync()
        t = time.perf_counter()
        yield
        if self.t0 is not None:
            self.skip += time.perf_counter() - t

    def summary(self, batch: int) -> dict:
        """Medians (ms) of each span over the timed steps, their count,
        ``wall_ms`` a step and ``samples_per_s`` over the wall."""
        self._sync()
        t1 = time.perf_counter()
        out = {}
        for kind, marks in self.marks.items():
            ms = [a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                  else (b - a) * 1e3 for a, b in marks[self.warmup:]]
            out[kind] = statistics.median(ms) if ms else float("nan")
        n = len(self.marks["step"]) - self.warmup
        wall = (t1 - self.t0 - self.skip if self.t0 is not None
                else float("nan"))
        out.update(n=n, wall_ms=wall / max(n, 1) * 1e3,
                   samples_per_s=batch * n / wall if n > 0 else 0.0)
        return out


def gnn_batch(cfg, seed: int = 0, device="cuda"):
    """The GNN branch's one batch, on ``device``: the reference's graph,
    x (N, d_in) normal and labels uniform in [0, n_classes) from a CPU
    ``torch.Generator`` seeded with ``seed`` (card and host get the same
    values)."""
    from ..graph import WebGraphSpec, generate_webgraph
    from ..train.data import to_device
    g = generate_webgraph(WebGraphSpec(500, 4000, 0.2, seed=1))
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((g.n_nodes, cfg.d_in), generator=gen)
    labels = torch.randint(0, cfg.n_classes, (g.n_nodes,), generator=gen)
    return to_device({"x": x, "src": torch.from_numpy(g.src),
                      "dst": torch.from_numpy(g.dst), "labels": labels},
                     device)


def model_and_data(cfg, batch: int, seed: int = 0, device="cuda",
                   seq: int = 64):
    """(model, loss_fn(model, batch), batch_fn(step)) of an LM, GNN or
    recsys config: the reference's data config per architecture (``seq``
    tokens a row for an LM; the GNN's one graph batch, ``gnn_batch``,
    for every step)."""
    from ..kernels.ops import EdgeLayouts
    from ..models import recsys as rs
    from ..models.gnn import GIN, GINConfig, node_loss
    from ..models.transformer import Transformer, TransformerConfig
    from ..train import (DataConfig, bst_batch, lm_batch, recsys_batch,
                         twotower_batch)
    if isinstance(cfg, GINConfig):
        gbatch = gnn_batch(cfg, seed, device)
        lay = EdgeLayouts.build(gbatch["src"], gbatch["dst"],
                                gbatch["x"].shape[0])
        return (GIN(cfg, seed=seed, device=device),
                lambda m, b: node_loss(m, dict(b, lay=lay), cfg),
                lambda s: gbatch)
    if isinstance(cfg, TransformerConfig):
        dc = DataConfig(kind="lm", global_batch=batch, seq_len=seq,
                        vocab=cfg.vocab)
        return (Transformer(cfg, seed=seed, device=device),
                lambda m, b: m.loss(b), lambda s: lm_batch(dc, s))
    model = rs.build(cfg, seed=seed, device=device)
    if isinstance(cfg, rs.TwoTowerConfig):
        dc = DataConfig(kind="twotower", global_batch=batch)
        batch_fn = lambda s: twotower_batch(dc, s, cfg.n_users,  # noqa: E731
                                            cfg.n_items)
    elif isinstance(cfg, rs.BSTConfig):
        dc = DataConfig(kind="bst", global_batch=batch,
                        sparse_vocab=cfg.vocab)
        batch_fn = lambda s: bst_batch(dc, s, cfg.seq_len)  # noqa: E731
    else:
        dc = DataConfig(kind="recsys", global_batch=batch,
                        sparse_vocab=cfg.vocab_per_field)
        batch_fn = lambda s: recsys_batch(dc, s)  # noqa: E731
    return model, (lambda m, b: m.loss(b)), batch_fn


def checkpoint_tree(model, opt_state):
    """The checkpoint's tree: host arrays under the reference's keys."""
    from ..runtime import host_array
    from ..tree import tree_map
    return tree_map(host_array, {"params": model.to_tree(),
                                 "opt": opt_state})


def restore(ckpt_dir: str, model, opt_state):
    """Load the newest checkpoint of ``ckpt_dir`` into ``model`` and
    ``opt_state`` (in place); returns its step."""
    from .. import checkpoint as ck
    from ..runtime import host_array
    from ..tree import leaves, tree_map
    f32 = lambda _t: np.zeros((), np.float32)  # noqa: E731 (dtype only)
    own = lambda t: host_array(t.reshape(-1)[:1])  # noqa: E731 (bf16: |V2)
    like = {"params": tree_map(own, model.to_tree()),
            "opt": {"m": tree_map(f32, opt_state["m"]),
                    "v": tree_map(f32, opt_state["v"]),
                    "step": np.zeros((), np.int32)}}
    tree, step, _ = ck.restore(ckpt_dir, like)
    model.params_from_reference(tree["params"])
    with torch.no_grad():
        for name in ("m", "v"):
            for t, x in zip(leaves(opt_state[name]),
                            leaves(tree["opt"][name])):
                t.copy_(torch.from_numpy(np.asarray(x)))
    opt_state["step"] = torch.tensor(int(tree["opt"]["step"]),
                                     dtype=torch.int32)
    return step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-feasible)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default, the card) or cpu")
    args = ap.parse_args(argv)

    from .. import checkpoint as ck
    from ..configs import get_spec
    from ..runtime import resolve_device
    from ..train import AdamWConfig, init_opt_state, make_train_step
    from ..train.data import to_device

    try:
        spec = get_spec(args.arch)
    except KeyError as e:
        raise SystemExit(f"launch.train: {e.args[0]}")
    if spec.family not in ("lm", "gnn", "recsys"):
        raise SystemExit("use launch.rank for the ranking workload")
    dev = resolve_device(args.device)
    cfg = spec.smoke_config if args.smoke else spec.config
    model, loss, batch_fn = model_and_data(cfg, args.batch, 0, dev,
                                           seq=args.seq)
    # samples a step: the batch's rows (the GNN's: the graph's nodes)
    samples = batch_fn(0)["x"].shape[0] if spec.family == "gnn" \
        else args.batch

    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    step_fn = make_train_step(loss, opt_cfg, grad_accum=args.grad_accum)
    opt_state = init_opt_state(model)
    start = 0
    if args.resume and args.ckpt and ck.latest_step(args.ckpt) is not None:
        start = restore(args.ckpt, model, opt_state)
        print(f"resumed from step {start}")

    card = dev.type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(dev, warmup=2 if args.steps - start > 2 else 0)
    t0 = time.time()
    for s in range(start, args.steps):
        with timer.span("build"):
            batch = batch_fn(s)
        with timer.span("h2d"):
            batch = to_device(batch, dev)
        with timer.span("step"):
            _, opt_state, m = step_fn(model, opt_state, batch)
        if s % 10 == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm "
                  f"{float(m['grad_norm']):.3f}", flush=True)
        if args.ckpt and args.ckpt_every and (s + 1) % args.ckpt_every == 0:
            with timer.excluded():
                ck.save(args.ckpt, s + 1, checkpoint_tree(model, opt_state))
                ck.prune(args.ckpt, keep=3)
    t = timer.summary(samples)
    print(f"done: {args.steps - start} steps in {time.time() - t0:.1f}s")
    if t["n"] > 0:
        clock = "CUDA events" if card else "host clock"
        peak = (f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB"
                if card else "not measured")
        print(f"timing: step ms median {t['step']:.3f} over {t['n']} steps "
              f"({clock}); wall ms a step {t['wall_ms']:.3f} (host clock, "
              f"batch build and H2D included), "
              f"{t['samples_per_s']:.0f} samples/s over the wall; batch "
              f"build ms median {t['build']:.3f} (host clock), H2D ms "
              f"median {t['h2d']:.3f} ({clock}); peak allocated {peak}",
              flush=True)


if __name__ == "__main__":
    main()
