"""AdamW with fp32 moments, global-norm clipping, warmup+cosine schedule
(port of ``repro.train.optimizer``).

The reference's arithmetic, not ``torch.optim.AdamW``'s: bias correction
in f32 from the incremented step, weight decay inside ``delta``, then
``p - lr*delta``; moments in f32; gradients clipped by the global norm
over every leaf. The state is the reference's tree ``{"m", "v",
"step"}`` (``step`` an int32 scalar, kept on the host so the schedule
needs no device read), so a checkpoint of either package restores in the
other.

The update runs in place, leaf by leaf in chunks of ``CHUNK`` elements,
in the reference's order of operations: at DLRM's full size one f32 leaf
is 6.66 GB, and the reference's out-of-place formula would hold several
such temporaries.
"""
from __future__ import annotations

import dataclasses
import math
import sys

import numpy as np
import torch

from ..models.sharding import shard_like
from ..tree import leaves, tree_map

CHUNK = 1 << 26  # elements of a leaf updated at once (256 MB of f32)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> float:
    """Linear warmup, then cosine decay to ``min_lr_frac``, in f32 as the
    reference computes it (returned as a Python float of the f32)."""
    f = np.float32
    step = f(int(step))
    warm = step / f(max(cfg.warmup_steps, 1))
    prog = (step - f(cfg.warmup_steps)) / f(
        max(cfg.total_steps - cfg.warmup_steps, 1))
    prog = f(min(max(prog, f(0.0)), f(1.0)))
    cos = f(cfg.min_lr_frac) + f((1 - cfg.min_lr_frac) * 0.5) * (
        f(1) + np.cos(f(math.pi) * prog, dtype=np.float32))
    return float(f(cfg.lr) * (warm if step < cfg.warmup_steps else cos))


def _params_tree(params):
    return params.to_tree() if hasattr(params, "to_tree") else params


def init_opt_state(params):
    """Zero f32 moments shaped like ``params`` (a module or a tree)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    tree = _params_tree(params)
    return {"m": tree_map(zeros, tree), "v": tree_map(zeros, tree),
            "step": torch.zeros((), dtype=torch.int32)}


def global_norm(tree):
    """sqrt of the sum over leaves of sum(g**2), in f32 (a 0-d tensor on
    the leaves' device)."""
    gs = [g.float() for g in leaves(tree)]
    norms = torch._foreach_norm(gs)
    return torch.sqrt(sum(n.square() for n in norms))


def clip_by_global_norm(grads, clip):
    """Scale every leaf by min(1, clip / max(norm, 1e-12)), in place for
    f32 leaves (others are cast to f32 first); returns (grads, norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(clip / torch.clamp(gn, min=1e-12), max=1.0)

    def sc(g):
        if g.dtype != torch.float32:
            g = g.float()
        return g.mul_(scale)
    return tree_map(sc, grads), gn


def _chunks(p, g, m, v):
    """(p, g, m, v) in flat chunks of ``CHUNK`` elements. A ``DTensor``
    leaf (the dry-run's sharded step) updates whole: the update is
    elementwise, so each device updates its own shard, and flattening a
    leaf sharded on an inner axis would regroup its shards."""
    dt = sys.modules.get("torch.distributed.tensor")  # loaded if p is one
    if dt is not None and isinstance(p, dt.DTensor):
        return [(p, g, m, v)]
    pf, mf, vf = (t.view(-1) for t in (p, m, v))
    gf = g.reshape(-1)  # a gradient may be strided (unembed's is transposed)
    return [(pf[s:s + CHUNK], gf[s:s + CHUNK], mf[s:s + CHUNK],
             vf[s:s + CHUNK]) for s in range(0, pf.numel(), CHUNK)]


def _update_leaf(p, g, m, v, lr, bc1, bc2, cfg: AdamWConfig):
    """One leaf's AdamW step, in place, chunk by chunk:
    m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g²; delta = (m/bc1) /
    (sqrt(v/bc2) + eps) + wd*p; p = p - lr*delta."""
    for pc, gc, mc, vc in _chunks(p, g, m, v):
        mc.mul_(cfg.b1).add_(gc * (1 - cfg.b1))
        vc.mul_(cfg.b2).add_(gc.square().mul_(1 - cfg.b2))
        den = (vc / bc2).sqrt_().add_(cfg.eps)
        delta = (mc / bc1).div_(den)
        p32 = pc if pc.dtype == torch.float32 else pc.float()
        delta.add_(p32 * cfg.weight_decay)
        pc.copy_(p32 - delta.mul_(lr))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig):
    """One AdamW step. ``params``: a module (its ``to_tree()``) or a tree
    of tensors, updated in place; ``grads`` a tree of the same structure
    (clipped in place); ``state`` is updated in place too. Returns
    (params, state, {"lr", "grad_norm"}) like the reference."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, int(step))
    # (sharded, as the dry-run runs it: each gradient reduced to its
    # parameter's placements, the data-parallel all-reduce)
    grads = tree_map(shard_like, grads, _params_tree(params))
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    f = np.float32
    k = f(int(step))
    bc1 = float(f(1) - f(cfg.b1) ** k)
    bc2 = float(f(1) - f(cfg.b2) ** k)
    for p, g, m, v in zip(leaves(_params_tree(params)), leaves(grads),
                          leaves(state["m"]), leaves(state["v"])):
        _update_leaf(p, g, m, v, lr, bc1, bc2, cfg)
    state["step"] = step.to(torch.int32)
    return params, state, {"lr": lr, "grad_norm": gn}


def opt_state_specs(param_specs_tree):
    """Optimizer-state PartitionSpecs mirroring the param specs (``step``
    is a host scalar: replicated)."""
    from ..models.sharding import P
    return {
        "m": param_specs_tree,
        "v": param_specs_tree,
        "step": P(),
    }
