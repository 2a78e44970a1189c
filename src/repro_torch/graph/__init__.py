import numpy as np

from .generators import (PAPER_TABLE7, WebGraphSpec, all_paper_datasets,
                         bipartite_interactions, generate_webgraph,
                         paper_dataset)
from .partition import partition_edges, partition_edges_by_dst_block
from .sampler import SampledSubgraph, SamplerTables, khop_sizes, sample_khop
from .structure import (BSR, CSR, Graph, next_pow2, padded_neighbors, to_bsr,
                        to_csr)
from .subgraph import FocusedSubgraph, SubgraphExtractor, root_set_key


def from_reference(g) -> Graph:
    """A port ``Graph`` holding copies of another package's graph arrays
    (anything with ``n_nodes``/``src``/``dst``, e.g. the JAX package's
    numpy ``Graph``)."""
    return Graph(int(g.n_nodes), np.array(g.src, np.int32, copy=True),
                 np.array(g.dst, np.int32, copy=True))


__all__ = [
    "BSR", "CSR", "Graph", "next_pow2", "padded_neighbors", "to_bsr",
    "to_csr", "PAPER_TABLE7", "WebGraphSpec", "all_paper_datasets",
    "bipartite_interactions",
    "generate_webgraph", "paper_dataset",
    "partition_edges", "partition_edges_by_dst_block",
    "SampledSubgraph", "SamplerTables", "khop_sizes", "sample_khop",
    "FocusedSubgraph", "SubgraphExtractor", "root_set_key", "from_reference",
]
