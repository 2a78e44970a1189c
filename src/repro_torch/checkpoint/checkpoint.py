"""Checkpointing with atomic manifests (port of
``repro.checkpoint.checkpoint``).

Layout: <dir>/step_<k>/arrays.npz + manifest.json. Writes go to a temp dir
and are os.replace'd into place, so a preemption mid-write never corrupts
the latest checkpoint. ``latest_step``/``restore`` drive cold restarts; the
serving spill (``serve.spill``) checkpoints through this module.

The format is the JAX package's, byte for byte where the arrays are: a
tree of dicts, lists and tuples flattens to ``SEP``-joined path keys
(``k=<dict key>``, ``i=<index>``) in the order ``jax.tree_util`` walks it
— dict keys sorted, ``None`` an empty subtree — so a checkpoint either
package writes restores in the other. Leaves are anything ``np.asarray``
takes (a bf16 tensor goes through ``runtime.host_array`` first: the
2-byte patterns the JAX package writes for a bf16 array).
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

from ..tree import tree_map_with_path, walk

SEP = "::"


def _flatten(tree) -> dict:
    return {SEP.join(path): np.asarray(leaf) for path, leaf in walk(tree)}


def _unflatten_into(template, arrays: dict):
    def leaf(path, like):
        key = SEP.join(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        return arr.astype(like.dtype) if hasattr(like, "dtype") else arr
    return tree_map_with_path(leaf, template)


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None):
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
        manifest = {"step": step, "time": time.time(), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _step_num(name: str) -> Optional[int]:
    """The ``step_<k>`` suffix as an int, or None for foreign/junk names
    (``step_backup``, editor droppings): a stray non-numeric dir must
    read as absent, not crash every reader that scans the directory."""
    if not name.startswith("step_"):
        return None
    try:
        return int(name[5:])
    except ValueError:
        return None


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        s = _step_num(name)
        if s is not None and os.path.exists(
                os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(s)
    return max(steps) if steps else None


def restore(ckpt_dir: str, template, step: Optional[int] = None):
    """Returns (tree, step, extra). ``template`` provides structure+dtypes."""
    arrays, step, extra = restore_arrays(ckpt_dir, step)
    return _unflatten_into(template, arrays), step, extra


def restore_arrays(ckpt_dir: str, step: Optional[int] = None):
    """Template-free restore: (flat {path-key: array}, step, extra), for a
    restarted process with no live tree to use as a template (the serving
    cache, whose entries' shapes are data-dependent)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, step, manifest.get("extra", {})


def prune(ckpt_dir: str, keep: int = 3):
    """Keep the newest ``keep`` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(s for s in map(_step_num, os.listdir(ckpt_dir))
                   if s is not None)
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
