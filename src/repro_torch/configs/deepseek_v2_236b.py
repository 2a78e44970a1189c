"""deepseek-v2-236b [arXiv:2405.04434; hf]: 60L d=5120 128H MLA(kv_lora=512)
MoE 2 shared + 160 routed top-6, d_expert=1536, vocab=102400."""
from ..models.transformer import TransformerConfig
from .base import ArchSpec, LM_SHAPES

CONFIG = TransformerConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_head=192, d_ff=0, vocab=102400,
    attn_type="mla", q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, top_k=6, n_shared=2, d_expert=1536,
    param_dtype="bfloat16", fsdp=True,
)

SMOKE_CONFIG = TransformerConfig(
    name="deepseek-v2-smoke", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_head=24, d_ff=0, vocab=128,
    attn_type="mla", q_lora_rank=32, kv_lora_rank=32,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    n_experts=8, top_k=2, n_shared=1, d_expert=32, remat=False,
)

SPEC = ArchSpec(
    arch_id="deepseek-v2-236b", family="lm", config=CONFIG,
    smoke_config=SMOKE_CONFIG, shapes=LM_SHAPES,
    skip_shapes={"long_500k": "full (MLA) attention is O(S^2); no "
                 "sub-quadratic path — skipped per assignment rules"},
)
