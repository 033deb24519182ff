"""GAT on Cora [arXiv:1710.10903; paper] — 2L d_hidden=8, 8 heads, attn agg.
d_in / n_classes are shape-dependent (Cora 1433/7; ogbn-products 100/47;
Reddit 602/41) and filled in per cell from the shape tables. The
reference's ``configs/gat_cora.py``."""
from repro_torch.models.gnn import GatConfig

CONFIG = GatConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8)
SMOKE = GatConfig(name="gat-smoke", n_layers=2, d_hidden=4, n_heads=2,
                  d_in=16, n_classes=5)
