"""MACE [arXiv:2206.07697; paper] — 2L d_hidden=128, l_max=2,
correlation order 3, n_rbf=8, E(3) higher-order message passing. The
reference's ``configs/mace.py``."""
from repro_torch.models.gnn import MaceConfig

CONFIG = MaceConfig(name="mace", n_layers=2, d_hidden=128, l_max=2,
                    correlation=3, n_rbf=8)
SMOKE = MaceConfig(name="mace-smoke", n_layers=1, d_hidden=8, l_max=2,
                   correlation=3, n_rbf=4)
