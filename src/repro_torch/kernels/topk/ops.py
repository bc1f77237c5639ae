"""Public wrappers: padding to power-of-two, top-k slicing, merge.

``sort_op`` and ``merge_sorted_op`` are the dispatch points the
:mod:`repro_torch.core.backend` layer calls: they own the pad-to-power-
of-two discipline ((BIG_DIST, ID_SENTINEL) filler sorts after every real
entry, payload lanes pad with zeros) and route to the CUDA network or
its plain version by mode. ``merge_sorted_op`` is the Gather stage's
fast path: two already-sorted lists become one bitonic row and a single
merge pass — no re-sorting of sorted data. ``merge_unsorted_op`` is that
stage as the engine runs it, proposals masked and sorted first, in one
launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.topk.kernel import (bitonic_merge, bitonic_sort,
                                             merge_unsorted)
from repro_torch.kernels.topk.ref import (bitonic_merge_ref, bitonic_sort_ref,
                                          filler, merge_unsorted_ref)
from repro_torch.utils import BIG_DIST, ID_SENTINEL, next_pow2


def _cuda_operands(dists, ids, payload):
    return ((dists.float().contiguous(), ids.to(torch.int32).contiguous())
            + tuple(p.contiguous() for p in payload))


def sort_op(dists: torch.Tensor, ids: torch.Tensor, *payload: torch.Tensor,
            mode: str = "auto"):
    """Lexicographic sort of the rows of (dists, ids); pads M to a power
    of two.

    Payload lanes (same (B, M) shape, i32/f32, any number, in either
    mode) ride along; they pad with zeros —
    padded entries sort after all real ones because the key filler is
    (BIG_DIST, ID_SENTINEL), so the padding never mixes into the
    returned M-prefix.
    """
    B, M = dists.shape
    m2 = next_pow2(M)
    if m2 != M:
        dists = torch.cat([dists, filler(dists, m2 - M, BIG_DIST)], dim=1)
        ids = torch.cat([ids, filler(ids, m2 - M, ID_SENTINEL)], dim=1)
        payload = tuple(torch.cat([p, filler(p, m2 - M, 0)], dim=1)
                        for p in payload)
    if resolve_kernel_mode(mode, dists) == "ref":
        out = bitonic_sort_ref(dists, ids, *payload)
    else:
        out = bitonic_sort(*_cuda_operands(dists, ids, payload))
    return tuple(x[:, :M] for x in out)


def topk_op(dists: torch.Tensor, ids: torch.Tensor, k: int,
            mode: str = "auto"):
    d, i = sort_op(dists, ids, mode=mode)
    return d[:, :k], i[:, :k]


def merge_sorted_op(d_a: torch.Tensor, i_a: torch.Tensor,
                    d_b: torch.Tensor, i_b: torch.Tensor,
                    pay_a: tuple = (), pay_b: tuple = (),
                    mode: str = "auto"):
    """Merge two per-row ascending (dist, id)-sorted lists into one.

    d_a/i_a : (B, LA) sorted rows (e.g. the candidate list)
    d_b/i_b : (B, LB) sorted rows (e.g. this round's sorted proposals)
    pay_a/pay_b : matching payload-lane tuples ((B, LA) / (B, LB) each,
                  i32/f32, any number)
    returns : (d, i, *pay) of width LA + LB, fully sorted.

    Construction: concat(A, filler, reversed(B)) padded to the next power
    of two is bitonic — ascending into the (BIG_DIST, ID_SENTINEL) peak,
    then descending — so a single merge pass sorts it. Filler sorts after
    every real entry, so the returned (LA + LB)-prefix is exactly the
    merged real rows.
    """
    if len(pay_a) != len(pay_b):
        raise ValueError(f"payload lanes must pair up across the two "
                         f"sides: {len(pay_a)} vs {len(pay_b)}")
    la, lb = d_a.shape[1], d_b.shape[1]
    padw = next_pow2(la + lb) - la - lb
    d = torch.cat([d_a, filler(d_a, padw, BIG_DIST), d_b.flip(1)], dim=1)
    i = torch.cat([i_a, filler(i_a, padw, ID_SENTINEL), i_b.flip(1)], dim=1)
    pay = tuple(torch.cat([pa, filler(pa, padw, 0), pb.flip(1)], dim=1)
                for pa, pb in zip(pay_a, pay_b))
    if resolve_kernel_mode(mode, d) == "ref":
        out = bitonic_merge_ref(d, i, *pay)
    else:
        out = bitonic_merge(*_cuda_operands(d, i, pay))
    return tuple(x[:, :la + lb] for x in out)


def merge_unsorted_op(cand_d: torch.Tensor, cand_i: torch.Tensor,
                      cand_e: torch.Tensor, new_d: torch.Tensor,
                      new_i: torch.Tensor, new_valid: torch.Tensor,
                      out_w: int, mode: str = "auto"):
    """The Gather merge: sorted candidate rows (cand_d, cand_i, cand_e)
    and unsorted proposals (new_d, new_i) with their ``new_valid`` mask
    give the first ``out_w`` merged (d, i, expanded) of each row — bit
    for bit ``sort_op`` of the masked proposals (expanded = False) then
    ``merge_sorted_op``, cut to ``out_w``. One kernel launch in cuda mode
    (see :func:`repro_torch.kernels.topk.kernel.merge_unsorted`)."""
    if resolve_kernel_mode(mode, cand_d) == "ref":
        return merge_unsorted_ref(cand_d, cand_i, cand_e, new_d, new_i,
                                  new_valid, out_w)
    return merge_unsorted(cand_d, cand_i, cand_e, new_d, new_i, new_valid,
                          out_w)
