"""Gemma-7B [arXiv:2403.08295; hf] — 28L d3072 16H (kv=16, i.e. MHA at 7B;
MQA only on 2B) d_ff 24576, vocab 256000, GeGLU, head_dim=256 (explicit),
embeddings scaled by sqrt(d_model). The reference's
``configs/gemma_7b.py``."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="gemma-7b", n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000, activation="gelu",
    embed_scale=True,
)

SMOKE = TransformerConfig(
    name="gemma-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=128, vocab_size=256, activation="gelu",
    embed_scale=True, dtype="float32", attn_chunk=16,
)
