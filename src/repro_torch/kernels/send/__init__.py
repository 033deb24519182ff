from repro_torch.kernels.send.ops import (build_slot_ragged_layout,
                                         build_slot_tiled_layout, send_operands,
                                         send_pack, send_pack_pallas,
                                         send_payload_bucket)
from repro_torch.kernels.send.ref import send_pack_ref
from repro_torch.kernels.send.send import (send_pack_ragged,
                                          send_pack_ragged_plain,
                                          send_pack_tiled, send_pack_tiled_plain)
