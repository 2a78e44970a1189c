"""mixtral-8x7b [arXiv:2401.04088; hf]: 32L d=4096 32H GQA(kv=8) MoE 8e top-2
d_ff=14336, SWA window 4096, vocab=32000. SWA rolling-buffer cache bounds
long_500k decode memory -> that cell RUNS for this arch."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = TransformerConfig(
    name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=0, vocab=32000, window=4096,
    n_experts=8, top_k=2, d_expert=14336,
    param_dtype="bfloat16", fsdp=True,
)

SMOKE_CONFIG = TransformerConfig(
    name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_head=16, d_ff=0, vocab=128, window=16,
    n_experts=4, top_k=2, d_expert=64, remat=False,
)

SPEC = ArchSpec(
    arch_id="mixtral-8x7b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    notes="long_500k runs: SWA rolling KV cache (window=4096) is O(W) memory",
)
