from repro_torch.kernels.topk.kernel import bitonic_merge, bitonic_sort
from repro_torch.kernels.topk.ops import merge_sorted_op, sort_op, topk_op
from repro_torch.kernels.topk.ref import (bitonic_merge_ref, bitonic_sort_ref,
                                          topk_ref)

__all__ = ["bitonic_sort", "bitonic_merge", "sort_op", "topk_op",
           "merge_sorted_op", "bitonic_sort_ref", "bitonic_merge_ref",
           "topk_ref"]
