from repro_torch.kernels.topk.kernel import (bitonic_merge, bitonic_sort,
                                             merge_unsorted)
from repro_torch.kernels.topk.ops import (merge_sorted_op, merge_unsorted_op,
                                          sort_op, topk_op)
from repro_torch.kernels.topk.ref import (bitonic_merge_ref, bitonic_sort_ref,
                                          merge_unsorted_ref, topk_ref)

__all__ = ["bitonic_sort", "bitonic_merge", "merge_unsorted", "sort_op",
           "topk_op", "merge_sorted_op", "merge_unsorted_op",
           "bitonic_sort_ref", "bitonic_merge_ref", "merge_unsorted_ref",
           "topk_ref"]
