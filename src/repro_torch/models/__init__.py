"""Models of the port: the transformer LM family (dense, serving)."""
