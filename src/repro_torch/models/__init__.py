"""Models of the port: the transformer LM family (dense and MoE)."""
