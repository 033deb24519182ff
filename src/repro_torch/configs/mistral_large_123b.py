"""Mistral-Large-123B [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
— 88L d12288 96H (GQA kv=8) d_ff 28672 vocab 32768. head_dim=128. The
reference's ``configs/mistral_large_123b.py``; its SMOKE is the GQA case
(6 heads, 2 kv)."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="mistral-large-123b", n_layers=88, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=28672, vocab_size=32768, activation="silu",
)

SMOKE = TransformerConfig(
    name="mistral-large-smoke", n_layers=2, d_model=96, n_heads=6,
    n_kv_heads=2, d_ff=160, vocab_size=128, activation="silu",
    dtype="float32", attn_chunk=16,
)
