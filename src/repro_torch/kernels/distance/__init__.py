from repro_torch.kernels.distance.kernel import paged_distances
from repro_torch.kernels.distance.ops import (coalesce_num_tiles,
                                              coalesced_distance_op,
                                              paged_distance_op, pad_tiles)
from repro_torch.kernels.distance.ref import paged_distances_ref

__all__ = ["paged_distances", "paged_distance_op", "coalesce_num_tiles",
           "coalesced_distance_op", "pad_tiles", "paged_distances_ref"]
