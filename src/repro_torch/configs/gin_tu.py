"""gin-tu [arXiv:1810.00826; paper]: GIN, 5 layers, d_hidden=64, sum
aggregator, learnable eps. d_in/n_classes come from each graph shape."""
import dataclasses

from ..models.gnn import GINConfig
from .base import ArchSpec, GNN_SHAPES

CONFIG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64, d_in=64,
                   n_classes=2)

SMOKE_CONFIG = GINConfig(name="gin-tu-smoke", n_layers=2, d_hidden=16,
                         d_in=8, n_classes=3)


def for_shape(shape: dict) -> GINConfig:
    """Bind the arch to a shape's feature/class dims."""
    return dataclasses.replace(CONFIG, d_in=shape["d_feat"],
                               n_classes=shape["n_classes"])


SPEC = ArchSpec(
    arch_id="gin-tu", family="gnn", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=GNN_SHAPES,
    notes="message passing = jnp.take + segment_sum (JAX has no CSR); "
          "minibatch_lg uses the real fanout sampler (graph.sampler)",
)
