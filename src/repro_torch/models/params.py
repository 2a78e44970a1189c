"""Parameter trees as modules: a model whose parameters sit at the
reference's tree paths (``table``, ``bot.w.0``, ``layers.attn.wq``,
...). ``p["layers"]["attn"]["wq"]`` indexes a module as the reference
indexes its parameter dict, ``to_tree()`` gives the reference's nested
dict/tuple of the same tensors (what the optimizer and a checkpoint walk)
and ``params_from_reference`` copies a tree of arrays (e.g. the JAX
package's parameters) in.

Draws come from a seeded ``torch.Generator`` on the module's device;
``jax.random``'s bits cannot be reproduced, so tests carry the
reference's parameters across."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..runtime import from_host
from ..tree import tree_map


class ParamTree(nn.Module):
    """A module that reads as the reference's parameter dict: ``p[key]``
    is the child or parameter named ``key``; ``nn.ParameterList`` children
    stand for the reference's tuples."""

    def __getitem__(self, key):
        return getattr(self, key)

    def to_tree(self):
        """The reference's nested dict/tuple of this module's tensors."""
        out = {}
        for name, child in self.named_children():
            if isinstance(child, nn.ParameterList):
                out[name] = tuple(child)
            else:
                out[name] = child.to_tree()
        for name, p in self.named_parameters(recurse=False):
            out[name] = p
        return out

    @torch.no_grad()
    def params_from_reference(self, tree):
        """Copy a tree of arrays or tensors (the reference's structure: a
        dict of arrays, tuples and dicts; another module's ``to_tree()``;
        bf16 as ``ml_dtypes`` arrays or raw 2-byte patterns) into the
        parameters; returns self."""
        def put(p, x):
            x = x.detach() if torch.is_tensor(x) else from_host(np.asarray(x))
            if tuple(x.shape) != tuple(p.shape):
                raise ValueError(f"shape {tuple(x.shape)} for a parameter "
                                 f"of shape {tuple(p.shape)}")
            p.copy_(x)
        tree_map(put, self.to_tree(), tree)
        return self


class Group(ParamTree):
    """A dict of parameters and subtrees; a nested dict becomes a nested
    ``Group``."""

    def __init__(self, **items):
        super().__init__()
        for k, x in items.items():
            if isinstance(x, dict):
                x = Group(**x)
            setattr(self, k, x if isinstance(x, nn.Module)
                    else nn.Parameter(x))


def generator(seed: int, device):
    """A seeded generator on ``device``; None on ``meta``, where nothing
    is drawn (a model built there has shapes and dtypes only: the
    dry-run's step builders)."""
    if torch.device(device).type == "meta":
        return None
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def normal(gen, shape, scale, device, dtype=torch.float32):
    """``scale * N(0, 1)`` drawn in f32 on ``device``, cast to ``dtype``.
    A stacked leaf (three or more axes) of another dtype is drawn one
    leading slice at a time, so the f32 draw of a bf16 leaf (a 16-layer stack of mixtral's experts is 15 GB of
    bf16) never exists whole."""
    if dtype == torch.float32 or len(shape) < 3:
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).mul_(float(scale)).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        out[i] = normal(gen, shape[1:], scale, device)
    return out
