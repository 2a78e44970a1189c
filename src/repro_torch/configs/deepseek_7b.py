"""deepseek-7b [arXiv:2401.02954; hf]: llama-arch 30L d=4096 32H MHA(kv=32)
d_ff=11008 vocab=102400."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32,
    n_kv_heads=32, d_head=128, d_ff=11008, vocab=102400,
)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=16, d_ff=128, vocab=128, remat=False,
)

SPEC = ArchSpec(
    arch_id="deepseek-7b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skip_shapes={"long_500k": "pure full attention; no sub-quadratic path"},
)
