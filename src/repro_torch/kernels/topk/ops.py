"""Public wrappers: padding to power-of-two, top-k slicing, merge.

``sort_op`` and ``merge_sorted_op`` are the dispatch points the
:mod:`repro_torch.core.backend` layer calls: they own the pad-to-power-
of-two discipline ((BIG_DIST, ID_SENTINEL) filler sorts after every real
entry, payload lanes pad with zeros) and route to the CUDA network or
its plain version by mode. ``merge_sorted_op`` is the Gather stage's
fast path: two already-sorted lists become one bitonic row and a single
merge pass — no re-sorting of sorted data.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.topk.kernel import bitonic_merge, bitonic_sort
from repro_torch.kernels.topk.ref import bitonic_merge_ref, bitonic_sort_ref
from repro_torch.utils import BIG_DIST, ID_SENTINEL, next_pow2


def _fill(like: torch.Tensor, width: int, value) -> torch.Tensor:
    return like.new_full((like.shape[0], width), value)


def _cuda_operands(dists, ids, payload):
    return ((dists.float().contiguous(), ids.to(torch.int32).contiguous())
            + tuple(p.contiguous() for p in payload))


def sort_op(dists: torch.Tensor, ids: torch.Tensor, *payload: torch.Tensor,
            mode: str = "auto"):
    """Lexicographic sort of the rows of (dists, ids); pads M to a power
    of two.

    Payload lanes (same (B, M) shape) ride along; they pad with zeros —
    padded entries sort after all real ones because the key filler is
    (BIG_DIST, ID_SENTINEL), so the padding never mixes into the
    returned M-prefix.
    """
    B, M = dists.shape
    m2 = next_pow2(M)
    if m2 != M:
        dists = torch.cat([dists, _fill(dists, m2 - M, BIG_DIST)], dim=1)
        ids = torch.cat([ids, _fill(ids, m2 - M, ID_SENTINEL)], dim=1)
        payload = tuple(torch.cat([p, _fill(p, m2 - M, 0)], dim=1)
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
    pay_a/pay_b : matching payload-lane tuples ((B, LA) / (B, LB) each)
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
    d = torch.cat([d_a, _fill(d_a, padw, BIG_DIST), d_b.flip(1)], dim=1)
    i = torch.cat([i_a, _fill(i_a, padw, ID_SENTINEL), i_b.flip(1)], dim=1)
    pay = tuple(torch.cat([pa, _fill(pa, padw, 0), pb.flip(1)], dim=1)
                for pa, pb in zip(pay_a, pay_b))
    if resolve_kernel_mode(mode, d) == "ref":
        out = bitonic_merge_ref(d, i, *pay)
    else:
        out = bitonic_merge(*_cuda_operands(d, i, pay))
    return tuple(x[:, :la + lb] for x in out)
