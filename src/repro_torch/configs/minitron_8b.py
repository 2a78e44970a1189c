"""minitron-8b [arXiv:2407.14679; hf]: pruned nemotron, 32L d=4096 32H
GQA(kv=8) d_ff=16384 (squared-ReLU, 2-matrix MLP) vocab=256000."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = TransformerConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=16384, vocab=256000, mlp_type="relu2",
)

SMOKE_CONFIG = TransformerConfig(
    name="minitron-8b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_head=16, d_ff=128, vocab=128, mlp_type="relu2",
    remat=False,
)

SPEC = ArchSpec(
    arch_id="minitron-8b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skip_shapes={"long_500k": "pure full attention; no sub-quadratic path"},
)
