"""Plain PyTorch versions of the bitonic sort / top-k / merge kernels."""
from __future__ import annotations

import math

import torch

from repro_torch.utils import BIG_DIST, ID_SENTINEL, next_pow2


def filler(like: torch.Tensor, width: int, value) -> torch.Tensor:
    """(rows of ``like``, width) of ``value``, in ``like``'s dtype."""
    return like.new_full((like.shape[0], width), value)


def lexsort_pairs(dists: torch.Tensor, ids: torch.Tensor,
                  *payload: torch.Tensor):
    """Ascending lexicographic (dist, id) sort along the last axis:
    a stable sort by id, then a stable sort by dist. Payload operands
    are permuted alongside the keys."""
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    by_dist = torch.sort(dists.gather(-1, by_id), dim=-1, stable=True).indices
    perm = by_id.gather(-1, by_dist)
    return tuple(x.gather(-1, perm) for x in (dists, ids) + payload)


def bitonic_sort_ref(dists: torch.Tensor, ids: torch.Tensor,
                     *payload: torch.Tensor):
    """Plain version of the full bitonic network: the same ascending
    (dist, id) order, a NaN after every number, equal keys in input
    order (the kernel breaks ties by input position)."""
    return lexsort_pairs(dists, ids, *payload)


def topk_ref(dists: torch.Tensor, ids: torch.Tensor, k: int):
    d, i = bitonic_sort_ref(dists, ids)
    return d[..., :k], i[..., :k]


def _partner(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Value at index idx ^ stride along the last axis."""
    return x.reshape(-1, 2, stride).flip(1).reshape(x.shape)


def cmp_exchange(d, i, pay, j: int, k: int):
    """One bitonic stage: partner = idx ^ (1<<j); ascending iff bit k unset.

    The reference's per-element rule, in torch ops: an element takes its
    partner's entry iff (ascending == is_lower) ? partner_less :
    !partner_less, with partner_less = dp < d | (dp == d & ip < i).
    """
    stride = 1 << j
    dp = _partner(d, stride)
    ip = _partner(i, stride)
    idx = torch.arange(d.shape[-1], device=d.device)
    is_lower = (idx & stride) == 0
    asc = (idx & (1 << k)) == 0
    partner_less = (dp < d) | ((dp == d) & (ip < i))
    take = torch.where(asc == is_lower, partner_less, ~partner_less)
    d = torch.where(take, dp, d)
    i = torch.where(take, ip, i)
    pay = tuple(torch.where(take, _partner(p, stride), p) for p in pay)
    return d, i, pay


def merge_network(d, i, pay):
    """The final merge pass alone: sorts any *bitonic* row ascending.

    With k = log2(m), bit k is never set inside a row, so every
    compare-exchange runs ascending — the last k-loop iteration of the
    full network: log2(m) stages instead of log2(m)*(log2(m)+1)/2.
    """
    stages = int(math.log2(d.shape[-1]))
    for j in range(stages - 1, -1, -1):
        d, i, pay = cmp_exchange(d, i, pay, j, stages)
    return d, i, pay


def bitonic_merge_ref(dists: torch.Tensor, ids: torch.Tensor,
                      *payload: torch.Tensor):
    """Plain version of the single merge pass over a bitonic row. Runs
    the same log2(M)-stage compare-exchange network as the kernel, so the
    ref tier keeps the network's cost model (a full sort would give the
    same result but re-sort sorted data)."""
    d, i, pay = merge_network(dists, ids, payload)
    return (d, i) + tuple(pay)


def merge_unsorted_ref(cand_d, cand_i, cand_e, new_d, new_i, new_valid,
                       out_w: int):
    """Plain version of the fused Gather merge: invalid proposals become
    (BIG_DIST, ID_SENTINEL) with payload 0; the proposals, padded to a
    power of two, are sorted and cut back to their width; then the row
    A ++ filler ++ reversed(B) runs the merge network, and the first
    ``out_w`` entries of (d, i, expanded) come back. The same bits as
    ``sort_op`` then ``merge_sorted_op`` on the masked proposals."""
    la, lb = cand_d.shape[1], new_d.shape[1]
    nd = torch.where(new_valid, new_d, BIG_DIST)
    ni = torch.where(new_valid, new_i, ID_SENTINEL)
    padb = next_pow2(lb) - lb
    nd, ni = lexsort_pairs(torch.cat([nd, filler(nd, padb, BIG_DIST)], 1),
                           torch.cat([ni, filler(ni, padb, ID_SENTINEL)], 1))
    nd, ni = nd[:, :lb], ni[:, :lb]
    padw = next_pow2(la + lb) - la - lb
    pay = cand_e.to(torch.int32)
    d, i, (p,) = merge_network(
        torch.cat([cand_d, filler(cand_d, padw, BIG_DIST), nd.flip(1)], 1),
        torch.cat([cand_i, filler(cand_i, padw, ID_SENTINEL), ni.flip(1)], 1),
        (torch.cat([pay, filler(pay, padw + lb, 0)], 1),))
    return d[:, :out_w], i[:, :out_w], p[:, :out_w] != 0
