"""ArchSpec: one assigned architecture + its shape set + smoke config
(port of ``repro.configs.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                    # "lm" | "gnn" | "recsys" | "ranking"
    config: Any                    # full-size model config
    smoke_config: Any              # reduced config for CPU smoke tests
    shapes: Dict[str, dict]        # shape_name -> shape params
    skip_shapes: Dict[str, str] = dataclasses.field(default_factory=dict)
    notes: str = ""


LM_SHAPES = {
    "train_4k":    {"kind": "train",  "seq_len": 4096,   "global_batch": 256},
    "prefill_32k": {"kind": "prefill", "seq_len": 32768,  "global_batch": 32},
    "decode_32k":  {"kind": "decode", "seq_len": 32768,  "global_batch": 128},
    "long_500k":   {"kind": "decode", "seq_len": 524288, "global_batch": 1},
}

GNN_SHAPES = {
    "full_graph_sm": {"kind": "gnn_full", "n_nodes": 2708, "n_edges": 10556,
                      "d_feat": 1433, "n_classes": 7},
    "minibatch_lg":  {"kind": "gnn_sampled", "n_nodes": 232965,
                      "n_edges": 114_615_892, "batch_nodes": 1024,
                      "fanout": (15, 10), "d_feat": 602, "n_classes": 41},
    "ogb_products":  {"kind": "gnn_full", "n_nodes": 2_449_029,
                      "n_edges": 61_859_140, "d_feat": 100, "n_classes": 47},
    "molecule":      {"kind": "gnn_graph", "n_nodes": 30, "n_edges": 64,
                      "global_batch": 128, "d_feat": 64, "n_classes": 2},
}

RECSYS_SHAPES = {
    "train_batch":    {"kind": "train", "global_batch": 65536},
    "serve_p99":      {"kind": "serve", "global_batch": 512},
    "serve_bulk":     {"kind": "serve", "global_batch": 262144},
    "retrieval_cand": {"kind": "retrieval", "global_batch": 1,
                       "n_candidates": 1_000_000},
}

# The paper's own workload (extra cells beyond the assigned 40): QI-HITS /
# accelerated-HITS power sweeps over web-scale synthetic graphs.
RANKING_SHAPES = {
    "webrank_200m": {"kind": "rank", "n_nodes": 20_000_000,
                     "n_edges": 200_000_000, "n_vectors": 1,
                     "dangling_frac": 0.92},
    "webrank_2b":   {"kind": "rank", "n_nodes": 100_000_000,
                     "n_edges": 2_000_000_000, "n_vectors": 1,
                     "dangling_frac": 0.92},
    "webrank_multi": {"kind": "rank", "n_nodes": 20_000_000,
                      "n_edges": 200_000_000, "n_vectors": 8,
                      "dangling_frac": 0.92},
}
