"""Qwen3-MoE-235B-A22B [hf] — 94L d4096 64H (GQA kv=4) MoE 128e top-8,
d_ff(expert)=1536, vocab 151936. head_dim=128 (Qwen3 public config; spec
omits it), QK-norm per head. The reference's
``configs/qwen3_moe_235b_a22b.py``."""
from repro_torch.models.transformer import MoeConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    moe=MoeConfig(n_experts=128, top_k=8, d_expert=1536),
    activation="silu", qk_norm=True, rope_theta=1_000_000.0,
)

SMOKE = TransformerConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=8, n_kv_heads=2,
    head_dim=16, d_ff=96, vocab_size=128,
    moe=MoeConfig(n_experts=8, top_k=2, d_expert=96),
    activation="silu", qk_norm=True, dtype="float32", attn_chunk=16,
)
