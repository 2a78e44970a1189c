"""Node reordering for BSR blocking (port of
``repro.core.reordering.blocking_permutation``; the compacted-hub HITS
variants of that module are not ported yet)."""
from __future__ import annotations

import numpy as np


def blocking_permutation(src: np.ndarray, dst: np.ndarray,
                         n: int) -> np.ndarray:
    """Node order that clusters structural nonzeros for BSR blocking.

    Dangling pages touch no hub chain, so ordering non-dangling pages first
    — each group by total degree descending — concentrates edges into the
    leading (bs x bs) blocks and leaves the dangling tail as all-zero block
    rows the BSR simply never stores. Returns ``perm`` with
    ``perm[new_id] = old_id`` (deterministic: ties break by original id).
    """
    outdeg = np.bincount(src, minlength=n)
    indeg = np.bincount(dst, minlength=n)
    dangling = outdeg == 0
    # lexsort: last key is primary — non-dangling first, then degree desc
    return np.lexsort((np.arange(n), -(indeg + outdeg),
                       dangling)).astype(np.int32)
