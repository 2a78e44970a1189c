"""Generic train step (port of ``repro.train.train_step``):
gradients by ``torch.autograd`` -> clip -> AdamW, with optional microbatch
gradient accumulation for memory-bound configs.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..tree import leaves, tree_map
from .optimizer import AdamWConfig, adamw_update


def _split(batch, n: int, i: int):
    """Microbatch i of n: rows [i*b/n, (i+1)*b/n) of every leaf."""
    def sl(x):
        per = x.shape[0] // n
        return x[i * per:(i + 1) * per]
    return tree_map(sl, batch)


def value_and_grad(loss_fn: Callable, params, batch):
    """(loss, grads): the loss as a 0-d tensor and the gradient of every
    parameter as a tree shaped like ``params.to_tree()``."""
    tree = params.to_tree()
    ps = leaves(tree)
    for p in ps:
        p.grad = None
    loss = loss_fn(params, batch)
    gs = torch.autograd.grad(loss, ps)
    it = iter(gs)
    return loss.detach(), tree_map(lambda _p: next(it), tree)


def make_train_step(loss_fn: Callable, opt_cfg: AdamWConfig,
                    grad_accum: int = 1):
    """loss_fn(params, batch) -> scalar tensor, ``params`` a recsys module.
    Returns step(params, opt_state, batch) -> (params, opt_state, metrics);
    params and opt_state are updated in place. With ``grad_accum`` > 1
    the batch's leading axis splits into that many microbatches; their
    losses are summed (from an f32 zero) and their gradients accumulated
    in f32, then both are divided by ``grad_accum``, as the reference's
    scan does."""

    def step(params, opt_state, batch):
        if grad_accum == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            loss, grads = None, None
            for i in range(grad_accum):
                li, gi = value_and_grad(loss_fn, params,
                                        _split(batch, grad_accum, i))
                if grads is None:
                    zero = torch.zeros((), dtype=torch.float32,
                                       device=li.device)
                    loss = zero + li
                    grads = tree_map(
                        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                              device=g.device).add_(g), gi)
                else:
                    loss = loss + li
                    grads = tree_map(lambda a, g: a.add_(g), grads, gi)
                del gi
            loss = loss / grad_accum
            grads = tree_map(lambda g: g.div_(grad_accum), grads)
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg)
        return params, opt_state, {"loss": loss, **om}

    return step
