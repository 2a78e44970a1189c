"""Restart-survivable cache spill for the query-ranking service (port of
``repro.serve.spill``, the same code over the port's ``checkpoint``: a
spill directory either package writes serves in the other).

``RankService``'s LRU holds converged authority/hub vectors per root-set
hash — exactly the state that is expensive to lose: Peserico & Pretto-style
adversarial graphs can take many sweeps to converge, so a restart that
drops the cache turns every popular query cold again. This module spills
entries through ``checkpoint.checkpoint`` (atomic manifest + os.replace
semantics, one checkpoint directory per root-set hash) so a fresh process
pointed at the same directory serves repeats from disk and warm-starts
overlaps from the restored score table.

Layout: ``<spill_dir>/<root-set-hash>/step_<gen>/{arrays.npz,manifest.json}``
— each cache entry is its own tiny checkpoint stream; refreshes bump the
generation and prune the old one, and a crash mid-write never corrupts the
previously-spilled generation (the checkpoint module's invariant).

Orthogonal to those per-entry *step* generations, the spill carries one
**data generation** for the whole directory (the ``DATA_GEN`` file):
every record is tagged with the generation it was written under, and
readers treat records from any other generation as absent. Explicit
invalidation — ``RankService.clear_result_cache`` and
``RankService.apply_edge_delta`` — bumps it, so cleared/pre-delta vectors
stay dead across both the serve path's disk fallback and restart-restore
instead of resurrecting from disk.

``PlanSpill`` gives ``SweepPlan`` layouts the same treatment under
``<spill_dir>/plans/`` — a restarted service skips layout rebuilds the
way the vector spill lets it skip re-convergence.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import zipfile
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from .. import checkpoint

# what a missing/truncated/corrupt/foreign checkpoint stream can raise on
# read — np.load throws BadZipFile when a damaged .npz still carries the
# zip magic; every reader here treats all of these as "entry absent"
_READ_ERRORS = (FileNotFoundError, OSError, KeyError, ValueError,
                zipfile.BadZipFile, EOFError)

# spill entries are flat {name: array} trees; checkpoint flattens dict
# keys as "k=<name>"
_FIELDS = ("nodes", "authority", "hub")


def _is_key(name: str) -> bool:
    return len(name) == 40 and all(c in "0123456789abcdef" for c in name)


def _gc_stream(entry_dir: str, keep: int) -> int:
    """Generation GC for one checkpoint stream: drop numeric ``step_*``
    dirs beyond the newest ``keep`` and sweep ``.tmp_*`` droppings a
    SIGKILL mid-``checkpoint.save`` can leave behind. Non-numeric
    ``step_*`` dirs (``step_backup``, editor droppings) are foreign data
    the reader already skips — never deleted. Returns dirs removed."""
    removed = 0
    try:
        names = os.listdir(entry_dir)
    except OSError:
        return 0
    gens = []
    for name in names:
        if name.startswith(".tmp_"):
            shutil.rmtree(os.path.join(entry_dir, name), ignore_errors=True)
            removed += 1
            continue
        if name.startswith("step_"):
            try:
                gens.append(int(name[5:]))
            except ValueError:
                pass  # foreign step_* dir: skip, don't delete
    for g in sorted(gens)[:-max(int(keep), 1)]:
        shutil.rmtree(os.path.join(entry_dir, f"step_{g:010d}"),
                      ignore_errors=True)
        removed += 1
    return removed


class CacheSpill:
    """Per-root-set-hash persistence of converged cache entries.

    ``keep_generations`` bounds how many ``step_*`` generations each
    entry's stream retains (refresh churn writes a new generation per
    re-convergence; without a bound a hot key's stream grows forever).
    ``gc()`` applies the same bound across every stream at once plus
    sweeps crash droppings — the startup/drain compaction pass.
    """

    def __init__(self, spill_dir: str, keep_generations: int = 1):
        self.dir = spill_dir
        self.keep_generations = max(int(keep_generations), 1)
        os.makedirs(spill_dir, exist_ok=True)
        self._gen_path = os.path.join(spill_dir, "DATA_GEN")
        self.data_generation = self._read_data_generation()

    def _read_data_generation(self) -> int:
        try:
            with open(self._gen_path) as f:
                return int(f.read().strip() or 0)
        except (OSError, ValueError):
            return 0  # fresh dir, or a legacy dir from before DATA_GEN

    def bump_data_generation(self) -> int:
        """Invalidate every record currently on disk.

        Bumps the directory-wide data generation (persisted atomically in
        the ``DATA_GEN`` file, so the invalidation survives restarts); all
        existing records were tagged with the old generation and now read
        as absent. New ``put``s write under the new generation. Returns
        the new generation."""
        self.data_generation = self._read_data_generation() + 1
        tmp = self._gen_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(f"{self.data_generation}\n")
        os.replace(tmp, self._gen_path)
        return self.data_generation

    def put(self, key: str, nodes: np.ndarray, authority: np.ndarray,
            hub: np.ndarray) -> str:
        entry_dir = os.path.join(self.dir, key)
        gen = (checkpoint.latest_step(entry_dir) or 0) + 1
        tree = {"nodes": np.asarray(nodes), "authority": np.asarray(authority),
                "hub": np.asarray(hub)}
        path = checkpoint.save(entry_dir, gen, tree,
                               extra={"key": key, "n_nodes": len(nodes),
                                      "data_gen": self.data_generation})
        checkpoint.prune(entry_dir, keep=self.keep_generations)
        return path

    def gc(self, keep: Optional[int] = None) -> int:
        """Compact every entry stream to its newest ``keep`` generations
        (default: ``keep_generations``) and remove ``.tmp_*`` leftovers
        from interrupted writes — in the spill root and inside each
        stream. Foreign files and non-numeric ``step_*`` dirs survive.
        Returns the number of directories removed."""
        keep = self.keep_generations if keep is None else max(int(keep), 1)
        removed = 0
        if not os.path.isdir(self.dir):
            return 0
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith(".tmp_") and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
            elif _is_key(name) and os.path.isdir(path):
                removed += _gc_stream(path, keep)
        return removed

    def get(self, key: str) -> Optional[Dict[str, np.ndarray]]:
        """{"nodes", "authority", "hub"} or None if absent/unreadable.

        Records written under a different data generation read as absent:
        explicitly-invalidated state (``clear_result_cache``, edge deltas)
        must stay dead even though its bytes are still on disk."""
        entry_dir = os.path.join(self.dir, key)
        try:
            arrays, _step, extra = checkpoint.restore_arrays(entry_dir)
        except _READ_ERRORS:
            return None
        try:
            if int(extra.get("data_gen", 0)) != self.data_generation:
                return None
        except (TypeError, ValueError):
            return None
        try:
            return {f: arrays[f"k={f}"] for f in _FIELDS}
        except KeyError:
            return None  # foreign/corrupt checkpoint in the spill dir

    def keys(self) -> List[str]:
        if not os.path.isdir(self.dir):
            return []
        return [n for n in os.listdir(self.dir)
                if _is_key(n) and checkpoint.latest_step(
                    os.path.join(self.dir, n)) is not None]

    def __contains__(self, key: str) -> bool:
        return checkpoint.latest_step(os.path.join(self.dir, key)) is not None

    def __len__(self) -> int:
        return len(self.keys())

    def load_recent(self, limit: Optional[int] = None
                    ) -> Iterable[Tuple[str, Dict[str, np.ndarray]]]:
        """Yield (key, entry) newest-spilled-first, up to ``limit``.

        Recency comes from the checkpoint manifests' write times, so a
        restarted service repopulates its LRU with the entries most
        recently converged before the restart — the ones traffic was
        actually hitting.
        """
        import json
        stamped = []
        for key in self.keys():
            entry_dir = os.path.join(self.dir, key)
            step = checkpoint.latest_step(entry_dir)
            try:
                with open(os.path.join(entry_dir, f"step_{step:010d}",
                                       "manifest.json")) as f:
                    t = json.load(f).get("time", 0.0)
            except (OSError, ValueError):
                continue
            stamped.append((t, key))
        stamped.sort(reverse=True)
        if limit is not None:
            stamped = stamped[:limit]
        for _t, key in stamped:
            e = self.get(key)
            if e is not None:
                yield key, e


class PlanSpill:
    """Persist ``SweepPlan`` layouts next to the vector spill.

    The vector spill makes converged *scores* survive a restart; this
    makes the structural *layouts* (edge shards, BSR blockings, device
    edge lists) survive too, so a restarted service skips the host-side
    rebuild the plan cache exists to avoid (the ROADMAP persist-plans
    item). One checkpoint stream per plan-cache key under
    ``<spill_dir>/plans/<sha1 of the key>/step_<gen>``; arrays come from
    ``SweepBackend.plan_arrays`` and rehydrate through ``plan_restore``.

    The full cache key — ``(backend, plan_params, structure_key)`` — is
    stored in the manifest and verified on read, so a foreign or
    hash-colliding record is rejected rather than rehydrated. Records
    also carry a format version: bump ``FORMAT`` whenever any backend's
    ``plan_arrays`` schema (or a device structure it serializes, like
    DeviceBSR's layout) changes meaning, and every stale record reads as
    absent instead of rehydrating into a silently wrong sweep.

    Format history: 2 — the precision ladder joined the service cache key
    (its third tuple element grew a ladder marker) and the bsr backend's
    meta gained "bulk"; pre-ladder records must not rehydrate under keys
    they were never built for. 3 — plan-time lumping joined the cache key
    (a ``lump:<map-hash>`` marker on the stop tuple) and plans may now be
    built from lump-reduced arrays; pre-lumping records must not alias
    reduced layouts they were never built for.
    """

    FORMAT = 3

    def __init__(self, spill_dir: str, keep_generations: int = 1):
        self.dir = os.path.join(spill_dir, "plans")
        self.keep_generations = max(int(keep_generations), 1)
        os.makedirs(self.dir, exist_ok=True)

    @staticmethod
    def _name(cache_key: tuple) -> str:
        return hashlib.sha1(repr(cache_key).encode()).hexdigest()

    def put(self, cache_key: tuple, arrays: Dict[str, np.ndarray],
            meta: dict) -> str:
        entry_dir = os.path.join(self.dir, self._name(cache_key))
        gen = (checkpoint.latest_step(entry_dir) or 0) + 1
        path = checkpoint.save(
            entry_dir, gen, {k: np.asarray(v) for k, v in arrays.items()},
            extra={"cache_key": repr(cache_key), "meta": meta,
                   "format": self.FORMAT})
        checkpoint.prune(entry_dir, keep=self.keep_generations)
        return path

    def gc(self, keep: Optional[int] = None) -> int:
        """Same generation GC as ``CacheSpill.gc``, over the plan streams
        (whose dir names are sha1 hexes of cache keys)."""
        keep = self.keep_generations if keep is None else max(int(keep), 1)
        removed = 0
        if not os.path.isdir(self.dir):
            return 0
        for name in os.listdir(self.dir):
            path = os.path.join(self.dir, name)
            if name.startswith(".tmp_") and os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
                removed += 1
            elif _is_key(name) and os.path.isdir(path):
                removed += _gc_stream(path, keep)
        return removed

    def get(self, cache_key: tuple
            ) -> Optional[Tuple[Dict[str, np.ndarray], dict]]:
        """(arrays, meta) for the key, or None (absent/foreign/corrupt)."""
        entry_dir = os.path.join(self.dir, self._name(cache_key))
        try:
            arrays, _step, extra = checkpoint.restore_arrays(entry_dir)
        except _READ_ERRORS:
            return None
        if extra.get("cache_key") != repr(cache_key) \
                or extra.get("format") != self.FORMAT:
            return None
        # checkpoint flattens dict keys as "k=<name>"
        out = {k[2:]: v for k, v in arrays.items() if k.startswith("k=")}
        return out, extra.get("meta", {})

    def __contains__(self, cache_key: tuple) -> bool:
        return checkpoint.latest_step(
            os.path.join(self.dir, self._name(cache_key))) is not None

    def __len__(self) -> int:
        if not os.path.isdir(self.dir):
            return 0
        return sum(1 for n in os.listdir(self.dir)
                   if checkpoint.latest_step(
                       os.path.join(self.dir, n)) is not None)
