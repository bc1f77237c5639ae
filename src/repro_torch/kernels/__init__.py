"""The port's hand-written Hopper kernels and their plain versions.

:data:`KERNELS` lists every kernel wrapper's handle; each carries a
plain integer count of its launches.
"""
from repro_torch.kernels.distance.kernel import KERNELS as _DISTANCE
from repro_torch.kernels.flash_attention.kernel import BWD_KERNEL as _BWD
from repro_torch.kernels.flash_attention.kernel import KERNEL as _FLASH
from repro_torch.kernels.topk.kernel import (MERGE_KERNEL,
                                             MERGE_UNSORTED_KERNEL,
                                             SORT_KERNEL)

KERNELS = (*_DISTANCE.values(), SORT_KERNEL, MERGE_KERNEL,
           MERGE_UNSORTED_KERNEL, _FLASH, _BWD)


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
