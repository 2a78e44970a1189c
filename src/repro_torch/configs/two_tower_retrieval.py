"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim=256,
tower MLP 1024-512-256, dot interaction, in-batch sampled softmax."""
from ..models.recsys import TwoTowerConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = TwoTowerConfig(name="two-tower-retrieval", embed_dim=256,
                        tower_mlp=(1024, 512, 256),
                        n_users=10_000_000, n_items=10_000_000)

SMOKE_CONFIG = TwoTowerConfig(name="two-tower-smoke", embed_dim=16,
                              tower_mlp=(32, 16), n_users=200, n_items=300)

SPEC = ArchSpec(
    arch_id="two-tower-retrieval", family="recsys", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES,
    notes="retrieval_cand scores 1M candidates with one batched dot (no "
          "loop); accelerated-HITS authority prior blendable "
          "(examples/retrieval_with_hits.py)",
)
