from repro_torch.kernels.relax.ops import (build_dst_ragged_layout,
                                          build_dst_tiled_layout,
                                          fixpoint_operands,
                                          relax_to_fixpoint)
from repro_torch.kernels.relax.relax import (
    relax_dst_ragged_fixpoint_batch, relax_dst_ragged_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_batch, relax_dst_tiled_fixpoint_batch_plain)
