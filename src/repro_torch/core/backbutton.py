"""Back-button model (paper §3.3): L* = L + M, where row i of M equals
column i of L when i is dangling (a surfer on a dangling page goes back).

Operationally: for every edge (u -> v) with v dangling, add (v -> u).
A copy of ``repro.core.backbutton`` over the port's numpy ``Graph``: the
same edges in the same order.
"""
from __future__ import annotations

import numpy as np

from ..graph.structure import Graph


def back_button(g: Graph) -> Graph:
    dang = g.dangling_mask()
    to_dangling = dang[g.dst]
    add_src = g.dst[to_dangling]
    add_dst = g.src[to_dangling]
    src = np.concatenate([g.src, add_src])
    dst = np.concatenate([g.dst, add_dst])
    return Graph(g.n_nodes, src, dst).dedup()
