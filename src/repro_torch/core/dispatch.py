"""Capacity-bounded shard dispatch — the Allocator discipline (§IV-C3).

The paper's Allocator gathers the candidates that target the same LUN
into that LUN's queue (bounded by queue capacity) so one page read serves
many queries. Here that is a dense, capacity-bounded bucket scatter
followed by an exchange of the bucket axes:

    items (M,) with destination shard ids
      -> buckets (S, C) + validity mask          (scatter, overflow drops)
      -> exchange                                (queries travel to data)
      -> remote compute
      -> exchange back                           (scalar results return)
      -> gather_from_buckets                     (results in item order)

Everything is static-shaped: overflow beyond capacity C is *dropped and
counted* — the bounded-LUN-queue behaviour. Every function takes any
number of leading batch axes (the engine passes the source-shard axis).
"""
from __future__ import annotations

import torch

INVALID = -1


def compute_ranks(dest: torch.Tensor, valid: torch.Tensor, num_shards: int):
    """Stable rank of each item within its destination bucket.

    dest: (..., M) in [0, S) (ignored where ~valid). Returns
    (rank (..., M) int64, counts (..., S) int64). Ranks are assigned in
    item order (first-come-first-served, like queue admission).
    """
    shards = torch.arange(num_shards, device=dest.device)
    onehot = (dest[..., None] == shards) & valid[..., None]    # (..., M, S)
    csum = torch.cumsum(onehot.long(), dim=-2)
    rank = csum.gather(-1, dest.long().clamp(0, num_shards - 1)[..., None]
                       )[..., 0] - 1
    return torch.where(valid, rank, 0), csum[..., -1, :]


def _bucket_slots(dest, rank, valid, capacity: int):
    """Flat bucket position of each item in a (..., S, capacity + 1)
    layout; dropped and masked items all land in the spill column
    ``capacity`` of bucket 0, which the callers slice off."""
    slot = torch.where(valid & (rank < capacity), rank, capacity)
    d = torch.where(valid, dest.long(), 0)
    return d * (capacity + 1) + slot


def scatter_to_buckets(dest, rank, valid, payload: torch.Tensor,
                       num_shards: int, capacity: int, fill=0):
    """payload (..., M, *rest) -> buckets (..., S, C, *rest). Overflow
    (rank >= C) drops."""
    lead = dest.shape[:-1]
    m = dest.shape[-1]
    rest = payload.shape[len(lead) + 1:]
    nb = 1
    for x in lead:
        nb *= x
    width = num_shards * (capacity + 1)
    pos = _bucket_slots(dest, rank, valid, capacity).reshape(nb, m)
    pos = pos + torch.arange(nb, device=pos.device)[:, None] * width
    out = payload.new_full((nb * width,) + rest, fill)
    out[pos.reshape(-1)] = payload.reshape((nb * m,) + rest)
    return out.reshape(lead + (num_shards, capacity + 1) + rest).narrow(
        len(lead) + 1, 0, capacity)


def bucket_mask(dest, rank, valid, num_shards: int, capacity: int):
    ok = valid & (rank < capacity)
    return scatter_to_buckets(dest, rank, valid, ok, num_shards, capacity,
                              fill=False)


def gather_from_buckets(buckets: torch.Tensor, dest, rank, valid,
                        capacity: int):
    """Inverse of scatter: results (..., S, C, *rest) -> (..., M, *rest)
    in item order; items that were not sent read zero."""
    lead = dest.shape[:-1]
    nl = len(lead)
    rest = buckets.shape[nl + 2:]
    ok = valid & (rank < capacity)
    flat = torch.where(ok, dest.long() * capacity + rank, 0)   # (..., M)
    b = buckets.reshape(lead + (-1,) + rest)
    idx = flat.reshape(flat.shape + (1,) * len(rest)).expand(
        flat.shape + rest)
    out = b.gather(nl, idx)
    return torch.where(ok.reshape(ok.shape + (1,) * len(rest)), out,
                       torch.zeros((), dtype=buckets.dtype,
                                   device=buckets.device))


def dispatch_stats(dest, rank, valid, num_shards: int, capacity: int):
    """(#items sent, #dropped to overflow, per-shard load) over the last
    axis (leading axes are batch axes)."""
    ok = valid & (rank < capacity)
    dropped = valid & (rank >= capacity)
    shards = torch.arange(num_shards, device=dest.device)
    onehot = (dest[..., None] == shards) & ok[..., None]
    return ok.sum(-1), dropped.sum(-1), onehot.sum(-2)


# ---------------------------------------------------------------------------
# Page-tile builder (offline, host): the SiN kernel consumes fixed (T, QB)
# tiles, one page per tile; this groups a routed batch by page id and pads
# each page group to QB rows.
# ---------------------------------------------------------------------------
def build_page_tiles(page_ids, payload_rows, qb: int):
    """numpy: group rows by page into (T, QB) tiles (INVALID-padded).

    Returns (tile_page (T,), tile_rows (T, QB) indices into payload order,
    tile_valid (T, QB)). ``payload_rows`` is unused, as in the reference.
    """
    import numpy as np

    page_ids = np.asarray(page_ids)
    order = np.argsort(page_ids, kind="stable")
    sorted_pages = page_ids[order]
    tiles_p, tiles_r, tiles_v = [], [], []
    i = 0
    m = len(sorted_pages)
    while i < m:
        j = i
        while j < m and sorted_pages[j] == sorted_pages[i]:
            j += 1
        group = order[i:j]
        for s in range(0, len(group), qb):
            chunk = group[s: s + qb]
            rows = np.full(qb, INVALID, dtype=np.int64)
            rows[: len(chunk)] = chunk
            tiles_p.append(sorted_pages[i])
            tiles_r.append(rows)
            tiles_v.append(rows != INVALID)
        i = j
    return (np.asarray(tiles_p, dtype=np.int32),
            np.stack(tiles_r).astype(np.int64),
            np.stack(tiles_v))
