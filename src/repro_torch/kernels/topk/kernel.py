"""Bitonic sort / merge (§IV-A "bitonic sorting" on the FPGA) — the
hand-written CUDA kernels' wrappers.

The paper offloads top-k selection to a bitonic sorting network on the
SmartSSD FPGA. Here ``csrc/bitonic.cu`` runs the network over each row
of (B, M), in one warp's registers up to M = 128 and in shared memory
beyond: the full network for :func:`bitonic_sort`, only the final merge
pass for :func:`bitonic_merge`. Rows sort ascending by (dist, id)
lexicographically; any number of (B, M) payload lanes, each i32 or
f32, ride along: one lane through the network itself; more as each
entry's input position through it and an epilogue in the same launch
that permutes every lane by the positions (up to :data:`MAX_LANES`
lanes a launch, one C entry for every count).
:func:`merge_unsorted` is the engine's Gather merge in one launch: it
masks and sorts the proposals and merges them into the sorted candidate
list, its ``expanded`` flags riding along as bytes.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.topk.ref import (bitonic_merge_ref, bitonic_sort_ref,
                                          merge_unsorted_ref)
from repro_torch.utils import next_pow2

SORT_KERNEL = Kernel(name="bitonic_sort", source="bitonic.cu",
                     entry="bitonic_launch",
                     replaces="src/repro/kernels/topk/kernel.py:118")
MERGE_KERNEL = Kernel(name="bitonic_merge", source="bitonic.cu",
                      entry="bitonic_launch",
                      replaces="src/repro/kernels/topk/kernel.py:130")
MERGE_UNSORTED_KERNEL = Kernel(
    name="bitonic_merge_unsorted", source="bitonic.cu",
    entry="merge_unsorted_launch",
    replaces="src/repro/kernels/topk/kernel.py:118,130")

MAX_M = 2048
#: payload lanes one launch carries (csrc/bitonic.cu kMaxLanes); more
#: take one more launch per MAX_LANES, each over the same keys
MAX_LANES = 4
LANE_DTYPES = (torch.int32, torch.float32)


def bitonic_cost(B: int, M: int, lanes: int, merge_only: bool) -> tuple:
    """(compare-exchanges, bytes) of one sort or merge launch over (B, M)
    rows with ``lanes`` payload lanes: the full network's M/2 log2 M
    (log2 M + 1) / 2 pairs a row, or the merge pass's M/2 log2 M; dist,
    id and every lane read once and written once (4 bytes an entry
    each)."""
    s = int(math.log2(M))
    pairs = (M // 2) * (s if merge_only else s * (s + 1) // 2)
    return float(B * pairs), float(2 * B * M * 4 * (2 + lanes))


def _launch_rows(kernel: Kernel, dists, ids, payload, merge_only: bool,
                 shared: bool):
    B, M = dists.shape
    if M < 1 or M > MAX_M or M & (M - 1):
        raise ValueError(f"{kernel.name}: row width M={M} must be a power "
                         f"of two in [1, {MAX_M}]")
    for k, p in enumerate(payload):
        if p.dtype not in LANE_DTYPES:
            raise TypeError(f"{kernel.name}: payload lane {k} is {p.dtype}; "
                            f"payload lanes are (B, M) i32/f32, permuted "
                            f"alongside the keys")
    specs = {"dists": (dists, torch.float32, (B, M)),
             "ids": (ids, torch.int32, (B, M))}
    specs.update({f"payload[{k}]": (p, p.dtype, (B, M))
                  for k, p in enumerate(payload)})

    # one launch per MAX_LANES lanes (one without lanes), each moving the
    # keys and its own lanes
    chunks = [(lo, min(MAX_LANES, len(payload) - lo))
              for lo in range(0, len(payload), MAX_LANES)] or [(0, 0)]
    if dists.is_meta:
        for _, n in chunks:
            kernel.shape_only(cost=lambda n=n: bitonic_cost(B, M, n,
                                                            merge_only))
        return tuple(torch.empty_like(x) for x in (dists, ids) + payload)
    check_cuda_operands(kernel.name, specs)
    outs = [torch.empty_like(x) for x in (dists, ids) + payload]
    if B == 0:
        return tuple(outs)
    tail = (B, M, int(math.log2(M)), int(merge_only), int(shared))
    for lo, n in chunks:
        lin = (ctypes.c_void_p * n)(*(p.data_ptr()
                                      for p in payload[lo:lo + n]))
        lout = (ctypes.c_void_p * n)(*(o.data_ptr()
                                       for o in outs[2 + lo:2 + lo + n]))
        kernel.launch(dists.data_ptr(), ids.data_ptr(), outs[0].data_ptr(),
                      outs[1].data_ptr(), ctypes.addressof(lin),
                      ctypes.addressof(lout), n, *tail,
                      cost=lambda n=n: bitonic_cost(B, M, n, merge_only))
    return tuple(outs)


def bitonic_sort(dists: torch.Tensor, ids: torch.Tensor,
                 *payload: torch.Tensor, shared: bool = False):
    """Ascending lexicographic (dist, id) sort of each row.

    dists (B, M) f32, ids (B, M) i32, M a power of two <= 2048, any
    number of (B, M) i32 or f32 payload lanes permuted alongside the keys
    bit for bit (another dtype raises on the card). CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise;
    "meta" tensors (a plan) get meta outputs and report the launch.
    ``shared`` runs the shared-memory body at any width (the register
    body takes M <= 128 otherwise), to hold the two against each other.
    """
    if not (dists.is_cuda or dists.is_meta):
        return bitonic_sort_ref(dists, ids, *payload)
    return _launch_rows(SORT_KERNEL, dists, ids, payload, merge_only=False,
                        shared=shared)


def bitonic_merge(dists: torch.Tensor, ids: torch.Tensor,
                  *payload: torch.Tensor, shared: bool = False):
    """Single merge pass over rows that are already *bitonic* in
    lexicographic (dist, id) order (ascending run, then descending run).

    Same shapes and contract as :func:`bitonic_sort`, but only the final
    log2(M) compare-exchange stages run. The caller (``merge_sorted_op``)
    builds the bitonic row from two sorted lists.
    """
    if not (dists.is_cuda or dists.is_meta):
        return bitonic_merge_ref(dists, ids, *payload)
    return _launch_rows(MERGE_KERNEL, dists, ids, payload, merge_only=True,
                        shared=shared)


def merge_unsorted_cost(R: int, la: int, lb: int, out_w: int) -> tuple:
    """(compare-exchanges, bytes) of one :func:`merge_unsorted` launch:
    the proposals' sort network over next_pow2(LB) and the merge stages
    over next_pow2(LA + next_pow2(LB)) per row; each operand read and
    each output written once (9 bytes per entry: dist, id, flag)."""
    mb = next_pow2(lb)
    s, M = int(math.log2(mb)), next_pow2(la + mb)
    cmps = R * ((mb // 2) * s * (s + 1) // 2 + (M // 2) * int(math.log2(M)))
    return float(cmps), float(R * (la * 9 + lb * 9 + out_w * 9))


def merge_unsorted(cand_d: torch.Tensor, cand_i: torch.Tensor,
                   cand_e: torch.Tensor, new_d: torch.Tensor,
                   new_i: torch.Tensor, new_valid: torch.Tensor, out_w: int,
                   *, shared: bool = False):
    """The Gather merge in one launch: sorted candidate rows and unsorted
    proposals in, the first ``out_w`` merged (d, i, expanded) out.

    cand_d (R, LA) f32 sorted by (dist, id), cand_i (R, LA) i32, cand_e
    (R, LA) bool; new_d (R, LB) f32 and new_i (R, LB) i32 unsorted,
    new_valid (R, LB) bool (invalid proposals become (BIG_DIST,
    ID_SENTINEL)); proposals carry expanded = False. 1 <= out_w <= LA +
    LB, LA + LB <= 2048. Bit for bit ``sort_op`` of the masked proposals
    then ``merge_sorted_op``, cut to ``out_w``. CPU tensors take the plain
    version; CUDA tensors launch the kernel or raise (every operand
    contiguous, of its dtype, on the current device: nothing is copied);
    "meta" tensors (a plan) get meta outputs and report the launch.
    """
    R, la = cand_d.shape
    lb = new_d.shape[-1]
    name = MERGE_UNSORTED_KERNEL.name
    if la < 1 or lb < 1 or next_pow2(la + lb) > MAX_M:
        raise ValueError(f"{name}: widths LA={la}, LB={lb} must be >= 1 "
                         f"with next_pow2(LA + LB) <= {MAX_M}")
    if not 1 <= out_w <= la + lb:
        raise ValueError(f"{name}: out_w={out_w} not in [1, {la + lb}]")
    if cand_d.is_meta:
        MERGE_UNSORTED_KERNEL.shape_only(
            cost=lambda: merge_unsorted_cost(R, la, lb, out_w))
        return (cand_d.new_empty((R, out_w)), cand_i.new_empty((R, out_w)),
                cand_e.new_empty((R, out_w)))
    if not cand_d.is_cuda:
        return merge_unsorted_ref(cand_d, cand_i, cand_e, new_d, new_i,
                                  new_valid, out_w)
    check_cuda_operands(name, {
        "cand_d": (cand_d, torch.float32, (R, la)),
        "cand_i": (cand_i, torch.int32, (R, la)),
        "cand_e": (cand_e, torch.bool, (R, la)),
        "new_d": (new_d, torch.float32, (R, lb)),
        "new_i": (new_i, torch.int32, (R, lb)),
        "new_valid": (new_valid, torch.bool, (R, lb))})
    out_d = cand_d.new_empty((R, out_w))
    out_i = cand_i.new_empty((R, out_w))
    out_e = cand_e.new_empty((R, out_w))
    if R:
        MERGE_UNSORTED_KERNEL.launch(
            *(x.data_ptr() for x in (cand_d, cand_i, cand_e, new_d, new_i,
                                     new_valid, out_d, out_i, out_e)),
            R, la, lb, out_w, int(shared),
            cost=lambda: merge_unsorted_cost(R, la, lb, out_w))
    return out_d, out_i, out_e
