"""Models of the port: the transformer LM family (dense and MoE), AutoInt
and the GNN zoo (GAT, EGNN, MACE, GraphCast)."""
