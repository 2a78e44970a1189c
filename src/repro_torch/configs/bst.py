"""bst [arXiv:1905.06874; paper]: Behavior Sequence Transformer (Alibaba):
embed_dim=32, seq_len=20, 1 block, 8 heads, MLP 1024-512-256."""
from ..models.recsys import BSTConfig
from .base import ArchSpec, RECSYS_SHAPES

CONFIG = BSTConfig(name="bst", embed_dim=32, seq_len=20, n_blocks=1,
                   n_heads=8, vocab=10_000_000, mlp=(1024, 512, 256))

SMOKE_CONFIG = BSTConfig(name="bst-smoke", embed_dim=16, seq_len=8,
                         n_blocks=1, n_heads=2, vocab=100, mlp=(32, 16))

SPEC = ArchSpec(
    arch_id="bst", family="recsys", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=RECSYS_SHAPES,
)
