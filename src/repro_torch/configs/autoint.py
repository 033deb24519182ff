"""AutoInt [arXiv:1810.11921; paper] — 39 sparse fields, embed_dim 16,
3 attention layers, 2 heads, d_attn=32. vocab_per_field=1e6 (Criteo-scale;
the spec leaves vocab open). The
reference's ``configs/autoint.py``."""
from repro_torch.models.autoint import AutoIntConfig

CONFIG = AutoIntConfig(name="autoint", n_sparse=39, vocab_per_field=1_000_000,
                       embed_dim=16, n_attn_layers=3, n_heads=2, d_attn=32)
SMOKE = AutoIntConfig(name="autoint-smoke", n_sparse=5, vocab_per_field=64,
                      embed_dim=8, n_attn_layers=2, n_heads=2, d_attn=8)
