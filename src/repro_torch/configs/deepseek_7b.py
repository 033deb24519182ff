"""DeepSeek-7B [arXiv:2401.02954; hf] — llama-arch: 30L d4096 32H (MHA kv=32)
d_ff 11008 vocab 102400, SwiGLU, head_dim=128. The reference's
``configs/deepseek_7b.py``."""
from repro_torch.models.transformer import TransformerConfig

CONFIG = TransformerConfig(
    name="deepseek-7b", n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400, activation="silu",
)

SMOKE = TransformerConfig(
    name="deepseek-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=192, vocab_size=256, activation="silu", dtype="float32",
    attn_chunk=16,
)
