"""Collectives of the multi-process ``shmap`` backend over
``torch.distributed`` (port of the reference's ``distributed/``)."""
from repro_torch.distributed.collectives import (AxisGroup, all_gather_tiled,
                                                 all_reduce_min,
                                                 all_to_all_tiled, and_reduce,
                                                 axis_sizes, flat_rank,
                                                 flat_size,
                                                 or_reduce, pmax_named,
                                                 pmin_named, psum_named,
                                                 ring_permute,
                                                 ring_permute_rev)

__all__ = ["AxisGroup", "all_gather_tiled", "all_reduce_min",
           "all_to_all_tiled", "and_reduce", "axis_sizes", "flat_rank", "flat_size",
           "or_reduce", "pmax_named", "pmin_named", "psum_named",
           "ring_permute", "ring_permute_rev"]
