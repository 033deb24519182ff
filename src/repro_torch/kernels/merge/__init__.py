from repro_torch.kernels.merge.merge import (merge_scatter_ragged,
                                            merge_scatter_ragged_plain,
                                            merge_scatter_tiled,
                                            merge_scatter_tiled_plain)
from repro_torch.kernels.merge.ops import (build_msg_ragged_layout,
                                          build_msg_tiled_layout, merge_scatter,
                                          merge_scatter_pallas)
from repro_torch.kernels.merge.ref import merge_scatter_ref
