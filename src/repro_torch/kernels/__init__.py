"""Hand-written CUDA kernels of the port, each with its plain PyTorch
version. The SP-Async round: ``relax`` (the K-query local fixpoint),
``send`` (the boundary pack), ``merge`` (the incoming scatter-min) and
``round`` (all three in one launch, the fused round). The standalone
kernel API: the single-query relax kernels (``relax_pallas``, one Jacobi
sweep; ``relax_masked_pallas``, a masked and counted sweep;
``relax_fixpoint_pallas``, the Gauss–Seidel fixpoint) and the embedding
bag (``embedding_bag.embedding_bag``; its kernel ``embedding_bag_p``; the
package, not the function, keeps the name here). The transformer's flash
attention (``flash_attention.flash_attention``; its kernel
``flash_attention_p``; here too the package keeps the name). ``build``
compiles and loads them; ``common`` and ``tile_reduce`` hold what they
share."""
from repro_torch.kernels.embedding_bag import (embedding_bag_jnp,
                                               embedding_bag_p,
                                               embedding_bag_ref)
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_p, flash_attention_p_plain)
from repro_torch.kernels.relax import (relax_fixpoint_pallas, relax_jnp,
                                       relax_masked_pallas, relax_pallas,
                                       relax_ref)
from repro_torch.kernels.round import (fused_round_operands,
                                      fused_round_pallas,
                                      fused_round_ragged,
                                      fused_round_ragged_plain,
                                      fused_round_ref, fused_round_rescue,
                                      fused_round_tiled,
                                      fused_round_tiled_plain)
