from repro_torch.kernels.relax.ops import (
    build_dst_ragged_layout, build_dst_tiled_layout, fixpoint_operands,
    relax_fixpoint_batch_pallas, relax_fixpoint_batch_ragged_pallas,
    relax_fixpoint_pallas, relax_jnp, relax_masked_pallas, relax_pallas,
    relax_to_fixpoint)
from repro_torch.kernels.relax.ref import relax_ref
from repro_torch.kernels.relax.relax import (
    relax_dst_ragged_fixpoint_batch, relax_dst_ragged_fixpoint_batch_plain,
    relax_dst_tiled, relax_dst_tiled_fixpoint,
    relax_dst_tiled_fixpoint_batch, relax_dst_tiled_fixpoint_batch_plain,
    relax_dst_tiled_fixpoint_plain, relax_dst_tiled_masked,
    relax_dst_tiled_masked_plain, relax_dst_tiled_plain)
