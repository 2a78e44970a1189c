"""dlrm-rm2 [arXiv:1906.00091; paper]: 13 dense + 26 sparse, embed_dim=64,
bot 13-512-256-64, top 512-512-256-1, dot interaction."""
from ..models.recsys import DLRMConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = DLRMConfig(name="dlrm-rm2", n_dense=13, n_sparse=26, embed_dim=64,
                    vocab_per_field=1_000_000,
                    bot_mlp=(13, 512, 256, 64), top_mlp=(512, 512, 256, 1))

SMOKE_CONFIG = DLRMConfig(name="dlrm-smoke", n_dense=13, n_sparse=26,
                          embed_dim=8, vocab_per_field=50,
                          bot_mlp=(13, 32, 8), top_mlp=(32, 16, 1))

SPEC = ArchSpec(
    arch_id="dlrm-rm2", family="recsys", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES,
    notes="EmbeddingBag = take + segment_sum over a unified table "
          "(26 x 1M rows x 64); table rows sharded over 'model'",
)
