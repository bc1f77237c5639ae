"""Plain PyTorch versions of the bitonic sort / top-k / merge kernels."""
from __future__ import annotations

import math

import torch


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
    (dist, id) order. Rows with an exact (dist, id) tie must carry equal
    payloads for the two to agree (the engine guarantees it)."""
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
