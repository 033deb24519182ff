"""Model configurations of the port: the dense LMs the transformer serves."""
