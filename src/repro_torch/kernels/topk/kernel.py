"""Bitonic sort / merge (§IV-A "bitonic sorting" on the FPGA) — the
hand-written CUDA kernel's wrappers.

The paper offloads top-k selection to a bitonic sorting network on the
SmartSSD FPGA. Here one CUDA kernel (``csrc/bitonic.cu``) runs the
network over each row of (B, M) in shared memory: the full network for
:func:`bitonic_sort`, only the final merge pass for
:func:`bitonic_merge`. Rows sort ascending by (dist, id)
lexicographically; at most one i32 payload lane rides along (the engine
packs its ``expanded`` flags into it).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.topk.ref import bitonic_merge_ref, bitonic_sort_ref

SORT_KERNEL = Kernel(name="bitonic_sort", source="bitonic.cu",
                     entry="bitonic_launch",
                     replaces="src/repro/kernels/topk/kernel.py:118")
MERGE_KERNEL = Kernel(name="bitonic_merge", source="bitonic.cu",
                      entry="bitonic_launch",
                      replaces="src/repro/kernels/topk/kernel.py:130")

MAX_M = 2048
ROW_THREADS = 256      # threads per block when several rows share one


def _launch_rows(kernel: Kernel, dists, ids, payload, merge_only: bool):
    B, M = dists.shape
    if M < 1 or M > MAX_M or M & (M - 1):
        raise ValueError(f"{kernel.name}: row width M={M} must be a power "
                         f"of two in [1, {MAX_M}]")
    if len(payload) > 1:
        raise ValueError(f"{kernel.name}: at most one payload lane, got "
                         f"{len(payload)}")
    specs = {"dists": (dists, torch.float32, (B, M)),
             "ids": (ids, torch.int32, (B, M))}
    if payload:
        specs["payload"] = (payload[0], torch.int32, (B, M))
    check_cuda_operands(kernel.name, specs)
    outs = [torch.empty_like(x) for x in (dists, ids) + payload]
    if B == 0:
        return tuple(outs)
    half = max(1, M // 2)
    rows = max(1, min(B, ROW_THREADS // half))
    pin, pout = ((payload[0].data_ptr(), outs[2].data_ptr()) if payload
                 else (None, None))
    kernel.launch(dists.data_ptr(), ids.data_ptr(), pin, outs[0].data_ptr(),
                  outs[1].data_ptr(), pout, B, M, int(math.log2(M)), rows,
                  int(merge_only))
    return tuple(outs)


def bitonic_sort(dists: torch.Tensor, ids: torch.Tensor,
                 *payload: torch.Tensor):
    """Ascending lexicographic (dist, id) sort of each row.

    dists (B, M) f32, ids (B, M) i32, M a power of two <= 2048, at most
    one (B, M) i32 payload lane permuted alongside the keys. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise.
    """
    if not dists.is_cuda:
        return bitonic_sort_ref(dists, ids, *payload)
    return _launch_rows(SORT_KERNEL, dists, ids, payload, merge_only=False)


def bitonic_merge(dists: torch.Tensor, ids: torch.Tensor,
                  *payload: torch.Tensor):
    """Single merge pass over rows that are already *bitonic* in
    lexicographic (dist, id) order (ascending run, then descending run).

    Same shapes and contract as :func:`bitonic_sort`, but only the final
    log2(M) compare-exchange stages run. The caller (``merge_sorted_op``)
    builds the bitonic row from two sorted lists.
    """
    if not dists.is_cuda:
        return bitonic_merge_ref(dists, ids, *payload)
    return _launch_rows(MERGE_KERNEL, dists, ids, payload, merge_only=True)
