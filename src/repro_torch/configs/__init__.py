"""Model configurations of the port: the LMs the transformer serves and
trains (dense and MoE), the GNN zoo, AutoInt, and the paper's SSSP
graphs as shape models."""
from repro_torch.configs.registry import ARCHS, SHAPES, build_cell, list_cells
