"""Hand-written CUDA kernels of the SP-Async round, each with its plain
PyTorch version: ``relax`` (the K-query local fixpoint), ``send`` (the
boundary pack) and ``merge`` (the incoming scatter-min). ``build`` compiles
and loads them; ``common`` and ``tile_reduce`` hold what they share."""
