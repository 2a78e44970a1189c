"""dcn-v2 [arXiv:2008.13535; paper]: 13 dense + 26 sparse, embed_dim=16,
3 full-rank cross layers, deep MLP 1024-1024-512."""
from ..models.recsys import DCNConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = DCNConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                   vocab_per_field=1_000_000, n_cross_layers=3,
                   deep_mlp=(1024, 1024, 512))

SMOKE_CONFIG = DCNConfig(name="dcn-smoke", n_dense=13, n_sparse=26,
                         embed_dim=4, vocab_per_field=50, n_cross_layers=2,
                         deep_mlp=(32, 16))

SPEC = ArchSpec(
    arch_id="dcn-v2", family="recsys", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES,
)
