from repro_torch.kernels.round.ops import (fused_round_operands,
                                          fused_round_pallas,
                                          fused_round_rescue)
from repro_torch.kernels.round.ref import fused_round_ref
from repro_torch.kernels.round.round import (fused_round_ragged,
                                            fused_round_ragged_plain,
                                            fused_round_tiled,
                                            fused_round_tiled_plain)
