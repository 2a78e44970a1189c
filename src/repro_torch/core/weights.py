"""The paper's acceleration weights (eq. 2-3).

ca_i = (indeg_i / deg_i) * |indeg_i - outdeg_i|^{p_i}
ch_i = (outdeg_i / deg_i) * |indeg_i - outdeg_i|^{-p_i}
p_i  = +1 if indeg>outdeg, -1 if indeg<outdeg, 0 otherwise.

With p_i = sign(indeg-outdeg), |indeg-outdeg|^{p_i} rewrites to:
  indeg>outdeg: ca_i scaled UP by the imbalance, ch_i scaled DOWN,
  indeg<outdeg: ca_i scaled DOWN, ch_i scaled UP,
  equal: both reduce to indeg/deg = outdeg/deg = 1/2 (or 0 for isolated).
The weights make authoritative pages more authoritative and hubby pages
more hubby, raising per-sweep convergence velocity for exactly the pages
farthest (in final score) from the uniform start vector.
"""
from __future__ import annotations

import numpy as np


def accel_weights(indeg: np.ndarray, outdeg: np.ndarray):
    """Return (ca, ch) float64 arrays per eq. 2-3. Isolated nodes get 0."""
    indeg = np.asarray(indeg, np.float64)
    outdeg = np.asarray(outdeg, np.float64)
    deg = indeg + outdeg
    safe_deg = np.where(deg > 0, deg, 1.0)
    diff = np.abs(indeg - outdeg)
    p = np.sign(indeg - outdeg)  # +1 / -1 / 0
    # |diff|^p with p in {-1,0,+1}; diff==0 only when p==0 -> factor 1
    safe_diff = np.where(diff > 0, diff, 1.0)
    factor_pos = safe_diff        # p = +1
    factor_neg = 1.0 / safe_diff  # p = -1
    fa = np.where(p > 0, factor_pos, np.where(p < 0, factor_neg, 1.0))
    fh = np.where(p > 0, factor_neg, np.where(p < 0, factor_pos, 1.0))
    ca = (indeg / safe_deg) * fa
    ch = (outdeg / safe_deg) * fh
    ca = np.where(deg > 0, ca, 0.0)
    ch = np.where(deg > 0, ch, 0.0)
    return ca, ch
