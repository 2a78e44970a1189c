"""Architecture registry (port of ``repro.configs``): ``--arch <id>``
resolves here. The port holds the recsys architectures and the paper's
own workload (``hits-webgraph``, whose ``RankingConfig`` holds the
serving defaults); the LM and GNN architectures are not ported yet, and
asking for one raises a ``KeyError`` that says so."""
from . import bst, dcn_v2, dlrm_rm2, hits_webgraph, two_tower_retrieval
from .base import ArchSpec

_MODULES = [two_tower_retrieval, dlrm_rm2, dcn_v2, bst, hits_webgraph]

REGISTRY = {m.SPEC.arch_id: m.SPEC for m in _MODULES}
ASSIGNED = [a for a in REGISTRY if a != "hits-webgraph"]

# the reference's other architectures, waiting for their model families
NOT_PORTED = ("deepseek-v2-236b", "mixtral-8x7b", "deepseek-7b",
              "minitron-4b", "minitron-8b", "gin-tu")


def get_spec(arch_id: str) -> ArchSpec:
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch '{arch_id}' is not ported yet: the LM and GNN "
                       f"families wait for ROADMAP item 11; ported: "
                       f"{sorted(REGISTRY)}")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]


def all_cells(include_ranking: bool = False):
    """Every (arch, shape) cell of the ported architectures, with skip
    reasons attached."""
    cells = []
    for arch_id, spec in REGISTRY.items():
        if spec.family == "ranking" and not include_ranking:
            continue
        for shape_name in spec.shapes:
            cells.append((arch_id, shape_name,
                          spec.skip_shapes.get(shape_name)))
    return cells
