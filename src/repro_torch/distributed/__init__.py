"""Collectives of the multi-process ``shmap`` backend over
``torch.distributed`` (port of the reference's ``distributed/``)."""
from repro_torch.distributed.collectives import (AxisGroup, all_gather_dim,
                                                 all_gather_tiled,
                                                 all_reduce_min,
                                                 all_to_all_tiled, and_reduce,
                                                 axis_sizes, copy_to_group,
                                                 flat_rank,
                                                 flat_size,
                                                 max_over_group,
                                                 or_reduce, pmax_named,
                                                 pmin_named, psum_named,
                                                 reduce_from_group,
                                                 reduce_scatter_dim,
                                                 ring_permute,
                                                 ring_permute_rev)

__all__ = ["AxisGroup", "all_gather_dim", "all_gather_tiled",
           "all_reduce_min", "all_to_all_tiled", "and_reduce", "axis_sizes",
           "copy_to_group", "flat_rank", "flat_size", "max_over_group",
           "or_reduce", "pmax_named", "pmin_named", "psum_named",
           "reduce_from_group", "reduce_scatter_dim", "ring_permute",
           "ring_permute_rev"]
