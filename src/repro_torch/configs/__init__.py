"""Model configurations of the port: the LMs the transformer serves and
trains, dense and MoE."""
