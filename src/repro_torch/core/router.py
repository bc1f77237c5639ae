"""Two-tier shard routing: coarse k-means router + routed index builder.

The fan-out serving path runs every query on every shard. NDSEARCH's
premise is the opposite: route each search to only the data that matters
(LUN-level locality). This module provides the coarse tier:

* :func:`build_routed_index` — partition the dataset into ``S``
  balanced, spatially-coherent shards (k-means + capacity-constrained
  assignment), build an independent Vamana graph per shard, stitch the
  shard medoids together so the fan-out leg still sees one connected
  graph, and pack it with ``stripe="sequential"`` so vertex ownership
  follows the partition.
* :class:`ShardRouter` — per-shard centroid sketches held on the
  device, scored with the paged SiN distance kernel (the shard index is
  the page id); emits each query's top-R shard set.
* :func:`fuse_topk` — log2(R) tree of the backend's bitonic merge over
  per-leg top-k lists, applied at retire time.

Everything here is host-side numpy build code except
``ShardRouter.shard_scores`` and ``fuse_topk``, which run on the device
through the kernel backend: on a card, ``csrc/paged_distance.cu`` and
``csrc/bitonic.cu``'s standalone sort (one launch each per routing
call) and its standalone merge (R - 1 launches per fusion).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.backend import KernelBackend
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import (INVALID, LUNCSR, Geometry, PackedIndex,
                                     pack_index)
from repro_torch.utils import BIG_DIST as MERGE_FILL_DIST
from repro_torch.utils import resolve_device

BIG_DIST = np.float32(3.4e38)
# fuse_topk's quarantined entries ride through the merge as
# (MERGE_FILL_DIST, id + _QUARANTINE_ID_SHIFT): ordered after every
# real entry, among themselves by id as at BIG_DIST, and before the
# merge's (MERGE_FILL_DIST, ID_SENTINEL) filler (ids stay below 2**30)
_QUARANTINE_ID_SHIFT = 2**30


# ---------------------------------------------------------------------------
# host-side k-means (build-time only; numpy on purpose)
# ---------------------------------------------------------------------------
def _kmeans(x: np.ndarray, ncl: int, seed: int = 0, iters: int = 25):
    """Lloyd k-means with k-means++ seeding. Returns (centroids
    (ncl, d), assign (n,)). The ++ init matters here: with well-
    separated shards a uniform random init routinely drops two seeds in
    one cluster and Lloyd never recovers, which splits a true cluster
    across two shards and wrecks both routing accuracy and load
    balance."""
    x = np.asarray(x, np.float32)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    cent = np.empty((ncl, x.shape[1]), np.float32)
    cent[0] = x[rng.integers(n)]
    d2min = ((x - cent[0]) ** 2).sum(-1)
    for c in range(1, ncl):
        p = d2min / max(d2min.sum(), 1e-30)
        cent[c] = x[rng.choice(n, p=p)]
        d2min = np.minimum(d2min, ((x - cent[c]) ** 2).sum(-1))
    xx = (x * x).sum(-1)
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = xx[:, None] - 2.0 * (x @ cent.T) + (cent * cent).sum(-1)[None, :]
        assign = d2.argmin(1)
        for c in range(ncl):
            sel = assign == c
            if sel.any():
                cent[c] = x[sel].mean(0)
            else:
                cent[c] = x[rng.integers(n)]
    return cent, assign


def _balanced_assign(x: np.ndarray, cent: np.ndarray, cap: int) -> np.ndarray:
    """Capacity-constrained cluster assignment (exactly ``cap`` per
    cluster). Points are processed in order of decreasing margin (gap
    between their best and second-best centroid): points that strongly
    prefer one cluster claim their seat first, points near a boundary
    get bumped to their next choice when a cluster fills up."""
    x = np.asarray(x, np.float32)
    n, ncl = x.shape[0], cent.shape[0]
    if cap * ncl != n:
        raise ValueError(f"capacity {cap} x {ncl} clusters != {n} points")
    d2 = ((x * x).sum(-1)[:, None] - 2.0 * (x @ cent.T)
          + (cent * cent).sum(-1)[None, :])
    pref = np.argsort(d2, axis=1)
    srt = np.sort(d2, axis=1)
    margin = srt[:, 1] - srt[:, 0] if ncl > 1 else np.zeros(n, np.float32)
    order = np.argsort(-margin)
    room = np.full(ncl, cap, np.int64)
    assign = np.full(n, -1, np.int64)
    for i in order:
        for c in pref[i]:
            if room[c] > 0:
                assign[i] = c
                room[c] -= 1
                break
    return assign


# ---------------------------------------------------------------------------
# coarse router
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardRouter:
    """Per-shard centroid sketch scored with the paged distance kernel.

    ``centroids`` is (S, C, d): C k-means centroids summarising each
    shard's local points, on the device the router scores on. A query's
    affinity to a shard is its distance to the *nearest* of that shard's
    centroids, which tolerates non-convex shards better than a single
    mean.
    """

    centroids: torch.Tensor     # (S, C, d) f32
    cnorm: torch.Tensor         # (S, C) f32 — squared norms
    backend: KernelBackend

    @property
    def num_shards(self) -> int:
        return self.centroids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def shard_scores(self, queries) -> torch.Tensor:
        """(nq, S) distance of each query to its nearest centroid per
        shard, on the router's device: one paged-distance call whose
        tile s is every query against shard s's centroid page."""
        q = torch.as_tensor(queries, dtype=torch.float32,
                            device=self.device)
        nq, d = q.shape
        S = self.num_shards
        # pad the query tile to a multiple of 8 rows, as the reference
        # pads it for its kernel backends
        pad = (-nq) % 8
        if pad:
            q = torch.cat([q, q.new_zeros((pad, d))], 0)
        qq = (q * q).sum(-1)
        # the kernel takes contiguous operands: the tile is S copies of
        # the queries, not a stride-0 view
        qt = q[None].expand(S, -1, -1).contiguous()
        qqt = qq[None].expand(S, -1).contiguous()
        pages = torch.arange(S, dtype=torch.int32, device=self.device)
        dist = self.backend.paged_distance(pages, qt, qqt, self.centroids,
                                           self.cnorm)
        return dist.min(-1).values.T[:nq]         # (S, nq+pad, C) -> (nq, S)

    def route(self, queries, topr: int) -> np.ndarray:
        """Top-R shard ids per query, best first. (nq, R) int32 on the
        host. The order is a stable argsort of the scores, as
        ``jnp.argsort``'s: equal scores break towards the lower shard.
        It is the backend's (score, shard) sort, on a card the
        standalone bitonic sort kernel (one launch)."""
        topr = min(int(topr), self.num_shards)
        score = self.shard_scores(queries).contiguous()
        shard = torch.arange(self.num_shards, dtype=torch.int32,
                             device=self.device).expand_as(score)
        _, order = self.backend.sort_pairs(score, shard.contiguous())
        return order[:, :topr].cpu().numpy()


# ---------------------------------------------------------------------------
# routed index build
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RoutedIndex:
    """A spatially-partitioned packed index plus its coarse router.

    ``db`` is the *permuted* dataset (shard-contiguous); result ids from
    a routed search index into this ordering. ``shard_entries`` are the
    per-shard medoid seeds as ``(evec (S, d), enorm (S,), eid (S,))``
    tensors on the router's device — the per-leg entry points for
    R < S serving.
    """

    db: np.ndarray
    packed: PackedIndex
    router: ShardRouter
    shard_entries: tuple
    medoids: np.ndarray         # (S,) global medoid ids


def build_routed_index(db: np.ndarray, *, shards: int, page_size: int,
                       r: int = 32, centroids_per_shard: int = 8,
                       pref_width: int = 0, seed: int = 0,
                       kernel_mode: str = "auto",
                       device="cuda") -> RoutedIndex:
    """Partition ``db`` into ``shards`` balanced spatial shards and pack.

    Each shard gets an independent Vamana graph over its local points
    (ids globalised by the shard offset), so a routed leg confined to one
    shard traverses a complete graph. The shard medoids are then
    stitched into a ring-of-medoids clique (each medoid's last S-1
    adjacency slots point at the other medoids) so the *fan-out* leg
    still sees one connected graph reaching every shard. The router's
    sketches and the shard entries live on ``device``.
    """
    dev = resolve_device(device)
    db = np.asarray(db, np.float32)
    n, d = db.shape
    S = int(shards)
    if n % (S * page_size) != 0:
        raise ValueError(
            f"n={n} must be divisible by shards*page_size={S * page_size}")
    m = n // S
    if r < S:
        raise ValueError(f"max degree r={r} must be >= shards={S} to stitch "
                         "the medoid clique")
    ppshard = m // page_size
    ppb = next(p for p in (4, 2, 1) if ppshard % p == 0)

    cent, _ = _kmeans(db, S, seed=seed)
    assign = _balanced_assign(db, cent, cap=m)
    order = np.argsort(assign, kind="stable")
    dbp = db[order]

    adj = np.full((n, r), INVALID, np.int32)
    medoids = np.zeros(S, np.int64)
    for s in range(S):
        local = dbp[s * m:(s + 1) * m]
        adj_s, med_s = build_vamana(local, r=r, seed=seed + s)
        adj_s = np.asarray(adj_s)
        adj[s * m:(s + 1) * m] = np.where(adj_s == INVALID, INVALID,
                                          adj_s + s * m)
        medoids[s] = s * m + int(med_s)

    # stitch: medoid clique over the last S-1 adjacency slots
    for s in range(S):
        others = np.asarray([medoids[t] for t in range(S) if t != s],
                            np.int32)
        if others.size:
            adj[medoids[s], r - others.size:] = others

    # global entry: the shard medoid nearest the dataset mean
    mean = dbp.mean(0)
    gaps = ((dbp[medoids] - mean) ** 2).sum(-1)
    entry = int(medoids[int(gaps.argmin())])

    geom = Geometry(num_shards=S, page_size=page_size, pages_per_block=ppb,
                    dim=d, stripe="sequential")
    idx = LUNCSR.from_adjacency(dbp, adj, geom, entry=entry,
                                pref_width=pref_width)
    packed = pack_index(idx, max_degree=r)

    rc = np.zeros((S, centroids_per_shard, d), np.float32)
    for s in range(S):
        rc[s], _ = _kmeans(dbp[s * m:(s + 1) * m],
                           min(centroids_per_shard, m), seed=seed + 1000 + s)
    router = ShardRouter(centroids=torch.as_tensor(rc, device=dev),
                         cnorm=torch.as_tensor((rc * rc).sum(-1), device=dev),
                         backend=KernelBackend(mode=kernel_mode))

    ev = dbp[medoids]
    shard_entries = (torch.as_tensor(ev, device=dev),
                     torch.as_tensor((ev * ev).sum(-1), device=dev),
                     torch.as_tensor(medoids.astype(np.int32), device=dev))
    return RoutedIndex(db=dbp, packed=packed, router=router,
                       shard_entries=shard_entries,
                       medoids=np.asarray(medoids))


def build_live_router(ep, centroids_per_shard: int = 8, seed: int = 0,
                      kernel_mode: str = "auto",
                      device="cuda") -> ShardRouter:
    """Fit a :class:`ShardRouter` over a live epoch's striped layout, its
    sketches on ``device``.

    The live index stripes the global graph across shards (unlike
    ``build_routed_index``'s spatial partition), so routing is only
    meaningful in the degenerate ``topr >= S`` fan-out mode; but the
    sketches still track the layout, so that :func:`refresh_router` has
    something of the same shape to refresh at each swap.
    """
    dev = resolve_device(device)
    S = ep.packed.geometry.num_shards
    zero = torch.zeros((S, centroids_per_shard, ep.vectors.shape[1]),
                       dtype=torch.float32, device=dev)
    base = ShardRouter(centroids=zero, cnorm=zero.sum(-1),
                       backend=KernelBackend(mode=kernel_mode))
    return refresh_router(base, ep, seed=seed)


def refresh_router(router: ShardRouter, ep, seed: int = 0) -> ShardRouter:
    """Recompute the per-shard centroid sketches for a new epoch (the
    router tracks layout churn).

    ``ep`` is a live :class:`~repro_torch.core.luncsr.EpochIndex`; each
    striping-owner shard's sketch is refit over its *live* vectors in the
    new epoch (called right after a reindex, so the delta is empty and
    the main mirror holds the whole live set). Shapes, device and backend
    are kept: the swap is a content update like every other.
    """
    g = ep.packed.geometry
    cap = ep.capacity
    owner = np.asarray(g.owner_of_n(np.arange(cap, dtype=np.int64), cap))
    live = (ep.ext_ids >= 0) & ~ep.tombs
    S, C, d = router.centroids.shape
    rc = np.zeros((S, C, d), np.float32)
    for s in range(S):
        pts = ep.vectors[live & (owner == s)]
        if len(pts) == 0:
            continue        # an empty shard keeps a zero sketch
        cents, _ = _kmeans(pts, min(C, len(pts)), seed=seed + 1000 + s)
        rc[s, :cents.shape[0]] = cents
        if cents.shape[0] < C:
            rc[s, cents.shape[0]:] = cents[0]   # pad: a duplicate, harmless
    dev = router.device
    return ShardRouter(centroids=torch.as_tensor(rc, device=dev),
                       cnorm=torch.as_tensor((rc * rc).sum(-1), device=dev),
                       backend=router.backend)


# ---------------------------------------------------------------------------
# retire-time fusion
# ---------------------------------------------------------------------------
def fuse_topk(leg_d, leg_i, backend: KernelBackend, k: int | None = None,
              device="cuda"):
    """Merge per-leg sorted top-k lists into one per-query top-k.

    ``leg_d``/``leg_i`` are (N, R, k) with INVALID-padded ids, each leg
    sorted by (dist, id); arrays move to ``device`` (tensors stay where
    they are). Legs of the same query searched disjoint shards, so
    there are no duplicate ids to collapse; a log2(R) tree of pairwise
    bitonic merges (each level truncated back to k) is exact. Returns
    (dists (N, k), ids (N, k)) tensors.

    Padded slots (INVALID ids) and non-finite distances (a corrupt or
    dropped leg) are quarantined to BIG_DIST, as the reference does, so
    they sort last among themselves by id and never poison the
    compare-exchanges (NaN compares are unordered). The merge's own
    filler is (MERGE_FILL_DIST, ID_SENTINEL), which sorts *before*
    BIG_DIST: so inside the tree a quarantined entry is carried as
    (MERGE_FILL_DIST, id + 2**30), which keeps the reference's order and
    keeps the filler out of every merged prefix, and is mapped back to
    (BIG_DIST, id) at the end.
    """
    if not isinstance(leg_d, torch.Tensor):
        dev = resolve_device(device)
        leg_d = torch.as_tensor(np.asarray(leg_d, np.float32), device=dev)
        leg_i = torch.as_tensor(np.asarray(leg_i, np.int32), device=dev)
    if k is None:
        k = leg_d.shape[-1]
    quarantine = (leg_i == INVALID) | ~torch.isfinite(leg_d)
    leg_d = torch.where(quarantine, MERGE_FILL_DIST, leg_d)
    leg_i = torch.where(quarantine, leg_i + _QUARANTINE_ID_SHIFT, leg_i)
    cur_d = [leg_d[:, j] for j in range(leg_d.shape[1])]
    cur_i = [leg_i[:, j] for j in range(leg_i.shape[1])]
    while len(cur_d) > 1:
        nd, ni = [], []
        for a in range(0, len(cur_d) - 1, 2):
            md, mi = backend.merge_pairs(cur_d[a], cur_i[a],
                                         cur_d[a + 1], cur_i[a + 1])
            nd.append(md[:, :k])
            ni.append(mi[:, :k])
        if len(cur_d) % 2:
            nd.append(cur_d[-1][:, :k])
            ni.append(cur_i[-1][:, :k])
        cur_d, cur_i = nd, ni
    fused_d, fused_i = cur_d[0][:, :k], cur_i[0][:, :k]
    # every quarantined entry (an all-INVALID row included) comes out as
    # (BIG_DIST, its id): never INVALID ids over stale 0.0 distances a
    # caller could mistake for perfect hits
    back = fused_i >= _QUARANTINE_ID_SHIFT + INVALID
    fused_d = torch.where(back, float(BIG_DIST), fused_d)
    fused_i = torch.where(back, fused_i - _QUARANTINE_ID_SHIFT, fused_i)
    return fused_d, fused_i
