"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 16L d2048 16H (GQA kv=16) MoE 64e top-8,
d_ff(expert)=1024, vocab 50304. head_dim = 2048/16 = 128. The reference's
``configs/olmoe_1b_7b.py``."""
from repro_torch.models.transformer import MoeConfig, TransformerConfig

CONFIG = TransformerConfig(
    name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304,
    moe=MoeConfig(n_experts=64, top_k=8, d_expert=1024),
    activation="silu", qk_norm=True,  # OLMoE uses QK-norm
)

SMOKE = TransformerConfig(
    name="olmoe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=64, vocab_size=128, moe=MoeConfig(n_experts=4, top_k=2, d_expert=64),
    activation="silu", qk_norm=True, dtype="float32", attn_chunk=16,
)
