"""Hand-written CUDA kernels of the SP-Async round, each with its plain
PyTorch version: ``relax`` (the K-query local fixpoint), ``send`` (the
boundary pack), ``merge`` (the incoming scatter-min) and ``round`` (all
three in one launch, the fused round). ``build`` compiles and loads them;
``common`` and ``tile_reduce`` hold what they share."""
from repro_torch.kernels.round import (fused_round_operands,
                                      fused_round_pallas,
                                      fused_round_ragged,
                                      fused_round_ragged_plain,
                                      fused_round_ref, fused_round_rescue,
                                      fused_round_tiled,
                                      fused_round_tiled_plain)
