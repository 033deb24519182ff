"""GraphCast [arXiv:2212.12794; unverified] — encoder-processor-decoder mesh
GNN: 16L d_hidden=512, mesh_refinement=6, sum aggregator, n_vars=227. The
reference's ``configs/graphcast.py``."""
from repro_torch.models.gnn import GraphcastConfig

CONFIG = GraphcastConfig(name="graphcast", n_layers=16, d_hidden=512,
                         n_vars=227, mesh_refinement=6)
SMOKE = GraphcastConfig(name="graphcast-smoke", n_layers=2, d_hidden=16,
                        n_vars=6)
