"""Public wrappers for the SiN distance kernel.

``paged_distance_op`` is the raw tile-level dispatch point;
``coalesced_distance_op`` is the two-level-scheduled form the engine's
phase-B distance stage routes through: it regroups per-assignment work
by physical page and packs up to ``qb`` same-page assignments into one
(qb, d) x (d, P) tile, so one page read serves many assignments (the
paper's Allocator batching same-page queries against the LUN page
buffer). Callers should normally go through
``KernelBackend.item_distances`` rather than calling these directly.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.distance.kernel import paged_distances
from repro_torch.kernels.distance.ref import paged_distances_ref
from repro_torch.utils import BIG_DIST, round_up


def paged_distance_op(page_ids: torch.Tensor, queries: torch.Tensor,
                      qq: torch.Tensor, db: torch.Tensor,
                      vnorm: torch.Tensor, mode: str = "auto") -> torch.Tensor:
    """mode: 'auto' | 'cuda' | 'ref'."""
    if resolve_kernel_mode(mode, queries) == "ref":
        return paged_distances_ref(page_ids, queries, qq, db, vnorm)
    return paged_distances(page_ids.to(torch.int32).contiguous(),
                           queries.contiguous(), qq.contiguous(),
                           db.contiguous(), vnorm.contiguous())


def coalesce_num_tiles(items: int, npages: int, qb: int) -> int:
    """Static (page, tile) count bound after coalescing ``items``
    assignments into per-page query tiles of width ``qb``.

    Page key p with ``c_p`` assignments packs into ``ceil(c_p / qb)``
    tiles. Summed: ``sum_p ceil(c_p/qb) = (items + sum_p r_p) / qb`` with
    ``r_p = (-c_p) mod qb <= qb - 1`` per distinct key, and at most
    ``K = min(npages + 1, items)`` distinct keys are occupied (the
    masked-item sentinel is the ``+ 1``). Hence the bound
    ``(items + K * (qb - 1)) // qb``, never more than ``items``.
    """
    if qb <= 0:
        raise ValueError(f"qb must be positive, got {qb}")
    K = min(npages + 1, items)
    return max(1, min(items, (items + K * (qb - 1)) // qb))


def coalesced_distance_op(ppage: torch.Tensor, slot: torch.Tensor,
                          mask: torch.Tensor, qvec: torch.Tensor,
                          qq: torch.Tensor, db: torch.Tensor,
                          vnorm: torch.Tensor, qb: int,
                          mode: str = "auto") -> torch.Tensor:
    """Per-assignment distances with one page read per up-to-``qb`` group.

    ppage/slot/mask/qq : (I,) physical page, slot-in-page, validity,
                         per-assignment query self-dot
    qvec               : (I, d) per-assignment query payload
    db, vnorm          : (NP, P, d), (NP, P) paged store
    returns            : (I,) f32; masked assignments get BIG_DIST.

    Every argument may carry a leading shard axis S ((S, I), (S, I, d),
    (S, NP, P, d), (S, NP, P)): each shard is tiled on its own, exactly
    as the unbatched call would tile it (``coalesce_num_tiles(I, NP,
    qb)`` tiles per shard), and the S * T tiles go to the kernel in one
    launch over the store viewed as S * NP pages.

    Two-level scheduling: assignments sort by physical page (masked ones
    key after every real page), each page's run is segmented into tiles
    of width ``qb``, and one tile serves the whole group. A scatter of
    the original positions undoes the regrouping.
    """
    if ppage.dim() == 1:
        return coalesced_distance_op(
            ppage[None], slot[None], mask[None], qvec[None], qq[None],
            db[None], vnorm[None], qb, mode)[0]
    S, items = ppage.shape
    d = qvec.shape[-1]
    npages, P = db.shape[1], db.shape[2]
    T = coalesce_num_tiles(items, npages, qb)
    dev = ppage.device
    srow = torch.arange(S, device=dev)[:, None]
    key = torch.where(mask, ppage.long(), npages)
    order = torch.argsort(key, dim=-1, stable=True)
    key_s = key.gather(-1, order)
    idx = torch.arange(items, device=dev).expand(S, items)
    is_start = torch.ones_like(key_s, dtype=torch.bool)
    is_start[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    rank_in_page = idx - run_start
    tile_id = torch.cumsum((rank_in_page % qb == 0).long(), dim=-1) - 1
    lane = rank_in_page % qb
    # pack the sorted assignments into (T, qb) tiles per shard; empty
    # trailing tiles keep the shard's page 0
    q_t = qvec.new_zeros((S, T, qb, d))
    q_t[srow, tile_id, lane] = qvec[srow, order]
    qq_t = qq.new_zeros((S, T, qb))
    qq_t[srow, tile_id, lane] = qq[srow, order]
    pid_t = torch.zeros((S, T), dtype=torch.long, device=dev)
    pid_t.scatter_reduce_(-1, tile_id, key_s, "amax", include_self=True)
    pid_t = pid_t.clamp(0, npages - 1) + srow * npages
    out = paged_distance_op(
        pid_t.reshape(S * T), q_t.reshape(S * T, qb, d),
        qq_t.reshape(S * T, qb), db.reshape(S * npages, P, d),
        vnorm.reshape(S * npages, P), mode=mode).reshape(S, T, qb, P)
    picked = out[srow, tile_id, lane, slot.long().gather(-1, order)]
    dist = torch.zeros((S, items), dtype=torch.float32, device=dev)
    dist.scatter_(-1, order, picked)
    return torch.where(mask, dist, BIG_DIST)


def pad_tiles(queries: torch.Tensor, qq: torch.Tensor, qb: int = 16):
    """Pad the query-tile axis QB up to a multiple of ``qb``."""
    T, QB, d = queries.shape
    tgt = round_up(QB, qb)
    if tgt == QB:
        return queries, qq
    queries = torch.cat([queries, queries.new_zeros((T, tgt - QB, d))], dim=1)
    qq = torch.cat([qq, qq.new_zeros((T, tgt - QB))], dim=1)
    return queries, qq
