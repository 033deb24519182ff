"""EGNN [arXiv:2102.09844; paper] — 4L d_hidden=64, E(n)-equivariant. The
reference's ``configs/egnn.py``."""
from repro_torch.models.gnn import EgnnConfig

CONFIG = EgnnConfig(name="egnn", n_layers=4, d_hidden=64)
SMOKE = EgnnConfig(name="egnn-smoke", n_layers=2, d_hidden=16, d_in=8)
