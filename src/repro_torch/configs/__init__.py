"""Architecture registry (port of ``repro.configs``): ``--arch <id>``
resolves here. The port holds every architecture of the reference, in
its order: the five LM architectures, the GNN (``gin-tu``), the recsys
architectures and the paper's own workload (``hits-webgraph``, whose
``RankingConfig`` holds the serving defaults)."""
from . import (bst, dcn_v2, deepseek_7b, deepseek_v2_236b, dlrm_rm2, gin_tu,
               hits_webgraph, minitron_4b, minitron_8b, mixtral_8x7b,
               two_tower_retrieval)
from .base import ArchSpec

_MODULES = [deepseek_v2_236b, mixtral_8x7b, deepseek_7b, minitron_4b,
            minitron_8b, gin_tu, two_tower_retrieval, dlrm_rm2, dcn_v2, bst,
            hits_webgraph]

REGISTRY = {m.SPEC.arch_id: m.SPEC for m in _MODULES}
ASSIGNED = [a for a in REGISTRY if a != "hits-webgraph"]

# architectures of the reference the port does not hold (none)
NOT_PORTED = ()


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_ranking: bool = False):
    """Every (arch, shape) cell, with skip reasons attached."""
    cells = []
    for arch_id, spec in REGISTRY.items():
        if spec.family == "ranking" and not include_ranking:
            continue
        for shape_name in spec.shapes:
            cells.append((arch_id, shape_name,
                          spec.skip_shapes.get(shape_name)))
    return cells
