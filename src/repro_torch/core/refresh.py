"""FTL-style block refresh simulation (§II-B2, §IV-B), host-side numpy.

NAND retention and read disturb force periodic block refreshes that move
data to new physical blocks; the paper keeps refreshes *within* a plane
so the multi-plane mapping survives, and updates the LUNCSR LUN/BLK
arrays so the Allocator still resolves logical ids without FTL
translation.

Here a "refresh" permutes the logical->physical block mapping within a
shard (a ``blk_perm`` row) and physically moves the affected db pages
and vnorm rows. Search results must be invariant
(tests/test_torch_engine_variants.py). The port's own copy of the
reference's module; ``physical_page_of`` lives in core/luncsr.py and is
re-exported here, where the reference keeps it.

The same machinery generalises to the live index's **background
reindex** (:func:`reindex_epoch`): instead of permuting blocks of a
frozen graph, rebuild the graph over the current live set (main
survivors + delta inserts), re-run the degree-ascending BFS reorder,
and pack the result at the session capacity so the swap is a pure
content update.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import (EpochIndex, PackedIndex, pack_padded,
                                     physical_page_of)
from repro_torch.core.reorder import apply_reordering, degree_ascending_bfs

__all__ = ["refresh_blocks", "physical_page_of", "reindex_epoch"]


def refresh_blocks(packed: PackedIndex, rng: np.random.Generator,
                   frac: float = 0.25) -> PackedIndex:
    """Refresh a random fraction of blocks per shard.

    Each refreshed block swaps physical position with another block of
    the same shard (a 2-cycle of the permutation), mirroring "copy to a
    free block, retire the old one" at steady state.

    The data move is a single gather by the composed physical-page
    permutation: logical page ``(b, i)`` of shard ``s`` moves from
    physical page ``old_perm[s, b] * ppb + i`` to ``new_perm[s, b] * ppb
    + i``. Both perms are bijections over the shard's blocks, so the
    gather covers every physical page exactly once and is the identity
    on unrefreshed blocks — bit-identical to the per-pair swap loop
    (:func:`_refresh_blocks_loop`, kept as the regression reference).
    """
    g = packed.geometry
    S, B = packed.blk_perm.shape
    ppb = g.pages_per_block
    old_perm = packed.blk_perm
    new_perm = old_perm.copy()
    for s in range(S):
        k = max(1, int(B * frac)) & ~1  # even count -> disjoint swap pairs
        if k < 2:
            continue
        chosen = rng.choice(B, size=k, replace=False)
        a, b = chosen[::2], chosen[1::2]
        new_perm[s, a], new_perm[s, b] = old_perm[s, b], old_perm[s, a]
    pages = B * ppb
    pib = np.arange(ppb, dtype=np.int64)
    src = (old_perm[:, :, None] * ppb + pib[None, None, :]).reshape(S, pages)
    dst = (new_perm[:, :, None] * ppb + pib[None, None, :]).reshape(S, pages)
    pagemap = np.empty((S, pages), dtype=np.int64)
    sidx = np.arange(S)[:, None]
    pagemap[sidx, dst] = src          # pagemap[s, new phys] = old phys
    db = packed.db[sidx, pagemap]
    vnorm = packed.vnorm[sidx, pagemap]
    return dataclasses.replace(packed, db=db, vnorm=vnorm, blk_perm=new_perm)


def _refresh_blocks_loop(packed: PackedIndex, rng: np.random.Generator,
                         frac: float = 0.25) -> PackedIndex:
    """The per-pair swap form (regression reference for
    :func:`refresh_blocks`; consumes the rng stream identically)."""
    g = packed.geometry
    S, B = packed.blk_perm.shape
    ppb = g.pages_per_block
    new_perm = packed.blk_perm.copy()
    db = packed.db.copy()
    vnorm = packed.vnorm.copy()
    for s in range(S):
        k = max(1, int(B * frac)) & ~1  # even count -> disjoint swap pairs
        if k < 2:
            continue
        chosen = rng.choice(B, size=k, replace=False)
        for a, b in zip(chosen[::2], chosen[1::2]):
            pa, pb = int(new_perm[s, a]), int(new_perm[s, b])
            new_perm[s, a], new_perm[s, b] = pb, pa
            ra = np.arange(pa * ppb, (pa + 1) * ppb)
            rb = np.arange(pb * ppb, (pb + 1) * ppb)
            db[s, ra], db[s, rb] = db[s, rb].copy(), db[s, ra].copy()
            vnorm[s, ra], vnorm[s, rb] = (vnorm[s, rb].copy(),
                                          vnorm[s, ra].copy())
    return dataclasses.replace(packed, db=db, vnorm=vnorm, blk_perm=new_perm)


def reindex_epoch(ep: EpochIndex, *, seed: int = 0,
                  pref_width: int = 0) -> EpochIndex:
    """Background reindex: fold the delta + tombstones into a fresh epoch.

    Collects the live set (main survivors + live delta rows), rebuilds
    the Vamana graph over it, re-runs the degree-ascending BFS reorder
    (static scheduling step 1 applied to the *new* graph), and packs at
    the session capacity. External ids ride along through the reorder
    permutation, so the result's ``ext_ids`` keeps every surviving
    vector addressable under its original name. The new epoch starts
    with an empty delta and a clear tombstone set.
    """
    main_live = (ep.ext_ids >= 0) & ~ep.tombs
    vecs = np.concatenate(
        [ep.vectors[main_live], ep.delta_vec[ep.delta_live]], axis=0)
    exts = np.concatenate(
        [ep.ext_ids[main_live], ep.delta_ext[ep.delta_live]], axis=0)
    if vecs.shape[0] < 2:
        raise ValueError("reindex needs at least 2 live vectors")
    r = ep.packed.max_degree
    adj, medoid = build_vamana(vecs, r=r, seed=seed)
    order = degree_ascending_bfs(adj)
    vecs, adj, entry = apply_reordering(vecs, adj, order, entry=medoid)
    exts = exts[order]
    packed = pack_padded(vecs, adj, ep.packed.geometry, entry, r,
                         capacity=ep.capacity, pref_width=pref_width)
    cap = ep.capacity
    m = vecs.shape[0]
    vmirror = np.zeros((cap, vecs.shape[1]), dtype=np.float32)
    vmirror[:m] = vecs
    emirror = np.full(cap, -1, dtype=np.int64)
    emirror[:m] = exts
    return EpochIndex.empty(packed, vmirror, emirror,
                            delta_cap=ep.delta_cap, epoch=ep.epoch + 1)
