"""Sharded NDSearch engine, simulated on one device (§IV dataflow).

Queries live on their *home* shard (the paper's SSD-controller query
property table); vectors + adjacency live sharded ("LUN groups"). One
search round is the paper's Allocating -> Searching -> Gathering
pipeline:

  phase A (Vgenerator): route the ids of the best-W unexpanded candidates
      to their owner shards; owners return adjacency rows (+ speculative
      2nd-order prefetch lists) from the sharded LUNCSR.
  phase B (Allocator + SiN): bucket (query vec, candidate id) assignments
      by candidate owner with bounded capacity (dropped-on-overflow ==
      bounded LUN queues); owners translate logical id -> physical
      (page, slot) via blk_perm arithmetic, compute distances where the
      vectors live, and return *scalar* distances ("filtering").
  merge (Gather + Sort): bloom-insert computed proposals, bitonic-merge
      into candidate lists, refresh termination mask.

The shard axis leads every array; the exchange between shards is a swap
of the (source, destination) bucket axes. Every stage works on all
shards at once — the reference's ``vmap`` over shards is written out as
that leading axis — so phase B is one distance launch per round over all
shards, and the merge one sort and one merge launch.

Hot paths dispatch through ``EngineParams.kernel_mode`` (a
:class:`repro_torch.core.backend.KernelBackend`): phase-B distances
become paged SiN kernel reads grouped by physical page, and the merge
runs the bitonic network — or inline torch ops in ``torch`` mode. All
modes are bit-identical on integer-valued vectors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.backend import KernelBackend
from repro_torch.core.dispatch import (bucket_mask, compute_ranks,
                                       gather_from_buckets,
                                       scatter_to_buckets)
from repro_torch.core.luncsr import PackedIndex, physical_page_of
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.traversal import (dedup_in_round, merge_candidates,
                                        select_expand)
from repro_torch.utils import (BIG_DIST, ID_SENTINEL, INVALID, bloom_insert,
                               bloom_query, resolve_device)


@dataclasses.dataclass(frozen=True)
class EngineGeom:
    """Static placement arithmetic (the Allocator's address generator)."""

    num_shards: int
    page_size: int
    pages_per_block: int
    pages_per_shard: int
    dim: int
    max_degree: int
    spec_stored: int
    n: int
    stripe: str = "striped"

    @staticmethod
    def from_packed(packed: PackedIndex) -> "EngineGeom":
        g = packed.geometry
        return EngineGeom(
            num_shards=g.num_shards, page_size=g.page_size,
            pages_per_block=g.pages_per_block,
            pages_per_shard=packed.pages_per_shard, dim=packed.db.shape[-1],
            max_degree=packed.max_degree, spec_stored=packed.pref.shape[-1],
            n=packed.n, stripe=g.stripe)

    def owner(self, vid):
        gp = vid // self.page_size
        if self.stripe == "striped":
            return gp % self.num_shards
        return gp // self.pages_per_shard

    def local_page(self, vid):
        gp = vid // self.page_size
        if self.stripe == "striped":
            return gp // self.num_shards
        return gp % self.pages_per_shard

    def logical_slot(self, vid):
        return self.local_page(vid) * self.page_size + vid % self.page_size

    def phys_page(self, vid, blk_perm):
        """vid (S, I) on shard s -> physical page via blk_perm (S, B)."""
        lpage = self.local_page(vid.long())
        blk = (lpage // self.pages_per_block).clamp(0, blk_perm.shape[-1] - 1)
        pib = lpage % self.pages_per_block
        return blk_perm.long().gather(-1, blk) * self.pages_per_block + pib


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Static engine configuration."""

    search: SearchParams
    capacity_a: int                 # phase-A request slots per destination
    capacity_b: int                 # phase-B assignment slots per destination
    sort_by_page: bool = True       # dynamic allocating (page-locality stats)
    spec_width: int = 0             # 2nd-order speculative prefetch width
    kernel_mode: str = "auto"       # hot-path backend: auto|cuda|ref|torch
                                    # (core/backend.py)
    coalesce_qb: int = 8            # per-page query-tile width in kernel
                                    # modes: one page read serves up to
                                    # this many assignments (0 = per-item)

    @property
    def backend(self) -> KernelBackend:
        return KernelBackend(mode=self.kernel_mode,
                             coalesce_qb=self.coalesce_qb)

    @staticmethod
    def lossless(search: SearchParams, queries_per_shard: int,
                 max_degree: int, spec_width: int = 0,
                 **kw) -> "EngineParams":
        """Capacities that can never overflow (for exactness tests)."""
        m = queries_per_shard * search.W * (max_degree + spec_width)
        return EngineParams(
            search=search,
            capacity_a=queries_per_shard * search.W,
            capacity_b=m, spec_width=spec_width, **kw)


class EngineState(NamedTuple):
    """Every field leads with the shard axis S."""

    cand_d: torch.Tensor     # (S, Qs, L) f32
    cand_i: torch.Tensor     # (S, Qs, L) i32
    cand_e: torch.Tensor     # (S, Qs, L) bool
    bloom: torch.Tensor      # (S, Qs, bloom_bits) bool
    done: torch.Tensor       # (S, Qs)
    rounds: torch.Tensor     # (S, Qs) rounds the row actually worked
    n_dist: torch.Tensor     # (S, Qs)
    items_recv: torch.Tensor     # (S,) items received by this shard's SiN
    pages_unique: torch.Tensor   # (S,) unique page reads (dynamic allocating)
    drops_b: torch.Tensor        # (S,) phase-B overflow drops at this source
    props_sent: torch.Tensor     # (S,) accepted proposals sent by this source


def _exchange(tree: dict) -> dict:
    """Source-major buckets (S_src, S_dst, ...) -> destination-major."""
    return {k: v.transpose(0, 1) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Stage functions — each works on all shards (leading axis S) at once.
# ---------------------------------------------------------------------------
def _init_state(queries, qq, entry_vec, entry_norm, entry_id: int,
                params: EngineParams) -> EngineState:
    S, Qs = queries.shape[:2]
    L = params.search.L
    dev = queries.device
    # multiply + reduce, as the reference writes it (not a matmul)
    e_d = (qq - 2.0 * (queries * entry_vec.float()).sum(-1)) + entry_norm
    cand_d = torch.cat([e_d[..., None],
                        torch.full((S, Qs, L - 1), BIG_DIST, device=dev)], -1)
    cand_i = torch.full((S, Qs, L), ID_SENTINEL, dtype=torch.int32,
                        device=dev)
    cand_i[..., 0] = entry_id
    cand_e = torch.zeros((S, Qs, L), dtype=torch.bool, device=dev)
    bloom = torch.zeros((S, Qs, params.search.bloom_bits), dtype=torch.bool,
                        device=dev)
    bloom = bloom_insert(bloom, cand_i[..., :1], ~cand_e[..., :1])
    z = torch.zeros((S, Qs), dtype=torch.int32, device=dev)
    zs = torch.zeros((S,), dtype=torch.int32, device=dev)
    return EngineState(cand_d, cand_i, cand_e, bloom, z.bool(), z, z,
                       zs, zs, zs, zs)


def _fa_select(state: EngineState, params: EngineParams, geom: EngineGeom):
    """Select W best unexpanded; bucket their ids by owner (phase A send)."""
    S, Qs = state.done.shape
    sel_ids, sel_valid, cand_e2 = select_expand(
        state.cand_d, state.cand_i, state.cand_e, params.search.W)
    sel_valid &= ~state.done[..., None]
    vid = sel_ids.reshape(S, -1)                        # (S, Qs*W)
    valid = sel_valid.reshape(S, -1)
    safe = vid.clamp(0, geom.n - 1)
    dest = torch.where(valid, geom.owner(safe), 0)
    rank, _ = compute_ranks(dest, valid, geom.num_shards)
    valid &= rank < params.capacity_a                  # lossless by default
    send = {
        "vid": scatter_to_buckets(dest, rank, valid, vid, geom.num_shards,
                                  params.capacity_a, fill=INVALID),
        "mask": bucket_mask(dest, rank, valid, geom.num_shards,
                            params.capacity_a),
    }
    keep = {"dest": dest, "rank": rank, "valid": valid, "cand_e2": cand_e2}
    return send, keep


def _fb_adjacency(recv, adj, pref, params: EngineParams, geom: EngineGeom):
    """Owner: serve adjacency rows (+ prefetch lists) for requested ids."""
    vid, mask = recv["vid"], recv["mask"]              # (S, S_src, C_A)
    shard = torch.arange(vid.shape[0], device=vid.device)[:, None, None]
    safe = vid.clamp(0, geom.n - 1)
    lslot = geom.logical_slot(safe).clamp(0, adj.shape[1] - 1).long()
    send = {"nbrs": torch.where(mask[..., None], adj[shard, lslot], INVALID)}
    if params.spec_width > 0:
        pr = pref[shard, lslot][..., :params.spec_width]
        send["pref"] = torch.where(mask[..., None], pr, INVALID)
    return send


def _fc_propose(state: EngineState, keep_a, recv_b, queries, qq, spec_w,
                params: EngineParams, geom: EngineGeom):
    """Build proposals, dedup + bloom-filter, bucket phase-B assignments.

    ``spec_w`` (S, Qs) is the per-query speculation width in
    [0, params.spec_width]; prefetch columns at or beyond a query's width
    are masked to INVALID.
    """
    S, Qs = state.done.shape
    W, R = params.search.W, geom.max_degree
    ka_valid = keep_a["valid"][..., None]
    nbrs = gather_from_buckets(recv_b["nbrs"], keep_a["dest"],
                               keep_a["rank"], keep_a["valid"],
                               params.capacity_a)       # (S, Qs*W, R)
    props = torch.where(ka_valid, nbrs, INVALID).reshape(S, Qs, W * R)
    if params.spec_width > 0:
        sw = params.spec_width
        pr = gather_from_buckets(recv_b["pref"], keep_a["dest"],
                                 keep_a["rank"], keep_a["valid"],
                                 params.capacity_a)
        pr = torch.where(ka_valid, pr, INVALID).reshape(S, Qs, W * sw)
        col = torch.arange(W * sw, device=pr.device) % sw
        keep_col = col < spec_w[..., None]
        props = torch.cat([props, torch.where(keep_col, pr, INVALID)], -1)
    M = props.shape[-1]
    valid = props != INVALID
    valid = dedup_in_round(props, valid)
    valid &= ~bloom_query(state.bloom, props)

    flat_vid = props.reshape(S, Qs * M)
    flat_valid = valid.reshape(S, Qs * M)
    dest = torch.where(flat_valid, geom.owner(flat_vid.clamp(0, geom.n - 1)),
                       0)
    rank, _ = compute_ranks(dest, flat_valid, geom.num_shards)
    ok = flat_valid & (rank < params.capacity_b)
    drops = (flat_valid & ~ok).sum(-1).to(torch.int32)

    qidx = torch.arange(Qs, device=props.device).repeat_interleave(M)
    C = params.capacity_b
    send = {
        "vid": scatter_to_buckets(dest, rank, ok, flat_vid, S, C,
                                  fill=INVALID),
        "mask": bucket_mask(dest, rank, ok, S, C),
        "qvec": scatter_to_buckets(dest, rank, ok, queries[:, qidx], S, C),
        "qq": scatter_to_buckets(dest, rank, ok, qq[:, qidx], S, C),
    }
    keep = {"dest": dest, "rank": rank, "ok": ok, "props": props,
            "drops": drops}
    return send, keep


def _fd_distance(recv, db, vnorm, blk_perm, params: EngineParams,
                 geom: EngineGeom):
    """Owner SiN: translate id -> physical page/slot, compute distances.

    Also counts page-buffer statistics per shard: unique pages (dynamic
    allocating shares a page read across assignments) vs raw items.
    """
    vid, mask = recv["vid"], recv["mask"]              # (S, S_src, C_B)
    S, _, C = vid.shape
    flat_vid = vid.reshape(S, -1).clamp(0, geom.n - 1)
    flat_mask = mask.reshape(S, -1)
    ppage = geom.phys_page(flat_vid, blk_perm).clamp(0, db.shape[1] - 1)
    slot = flat_vid % geom.page_size

    items = flat_mask.sum(-1).to(torch.int32)
    sorted_pages = torch.sort(torch.where(flat_mask, ppage, 2**30),
                              dim=-1).values
    first = torch.ones_like(flat_mask)
    first[:, 1:] = sorted_pages[:, 1:] != sorted_pages[:, :-1]
    uniq = (first & (sorted_pages != 2**30)).sum(-1).to(torch.int32)

    dist = params.backend.item_distances(
        ppage, slot, flat_mask, recv["qvec"].reshape(S, S * C, -1),
        recv["qq"].reshape(S, -1), db, vnorm)
    return {"dist": dist.reshape(S, S, C)}, items, uniq


def _fe_merge(state: EngineState, keep_a, keep_c, recv_d, items, uniq,
              params: EngineParams):
    """Requester: recover distances, bloom-insert, merge, re-terminate."""
    L = params.search.L
    props = keep_c["props"]                            # (S, Qs, M)
    S, Qs, M = props.shape
    dist = gather_from_buckets(recv_d["dist"], keep_c["dest"],
                               keep_c["rank"], keep_c["ok"],
                               params.capacity_b)
    accepted = keep_c["ok"].reshape(S, Qs, M)
    dist = torch.where(accepted, dist.reshape(S, Qs, M), BIG_DIST)
    keep = state.done

    bloom = bloom_insert(state.bloom, props, accepted)
    cand_d, cand_i, cand_e = merge_candidates(
        state.cand_d, state.cand_i, keep_a["cand_e2"], dist, props,
        accepted, L, backend=params.backend)
    worked = ~keep
    k3 = keep[..., None]
    cand_d = torch.where(k3, state.cand_d, cand_d)
    cand_i = torch.where(k3, state.cand_i, cand_i)
    cand_e = torch.where(k3, state.cand_e, cand_e)
    bloom = torch.where(k3, state.bloom, bloom)
    rounds = state.rounds + worked.int()
    n_dist = state.n_dist + torch.where(worked, accepted.sum(-1), 0).int()
    done = state.done | ~((~cand_e) & (cand_i != ID_SENTINEL)).any(-1)
    return EngineState(
        cand_d, cand_i, cand_e, bloom, done, rounds, n_dist,
        state.items_recv + items, state.pages_unique + uniq,
        state.drops_b + keep_c["drops"],
        state.props_sent + accepted.sum((1, 2)).int())


def _finalize(state: EngineState, k: int):
    out_i = torch.where(state.cand_i[..., :k] != ID_SENTINEL,
                        state.cand_i[..., :k], INVALID)
    stats = {
        "rounds": state.rounds, "n_dist": state.n_dist,
        "items_recv": state.items_recv, "pages_unique": state.pages_unique,
        "drops_b": state.drops_b, "props_sent": state.props_sent,
    }
    return out_i, state.cand_d[..., :k], stats


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
def pack_for_engine(packed: PackedIndex, device="cuda"):
    """PackedIndex -> (consts dict of tensors on ``device`` with a leading
    shard axis, geom, (entry_vec, entry_norm, entry_id))."""
    dev = resolve_device(device)
    geom = EngineGeom.from_packed(packed)
    consts = {name: torch.as_tensor(getattr(packed, name), device=dev)
              for name in ("db", "vnorm", "adj", "pref", "blk_perm")}
    # locate the entry vertex's physical position on its shard
    s, p, sl = (int(x[0]) for x in physical_page_of(packed, [packed.entry]))
    entry = (consts["db"][s, p, sl].float(), consts["vnorm"][s, p, sl],
             int(packed.entry))
    return consts, geom, entry


def _sim_round(state: EngineState, consts, queries, qq, spec_w,
               params: EngineParams, geom: EngineGeom) -> EngineState:
    """One engine round over all shards; exchanges swap the bucket axes."""
    send_a, keep_a = _fa_select(state, params, geom)
    send_b = _fb_adjacency(_exchange(send_a), consts["adj"], consts["pref"],
                           params, geom)
    send_c, keep_c = _fc_propose(state, keep_a, _exchange(send_b), queries,
                                 qq, spec_w, params, geom)
    send_d, items, uniq = _fd_distance(_exchange(send_c), consts["db"],
                                       consts["vnorm"], consts["blk_perm"],
                                       params, geom)
    return _fe_merge(state, keep_a, keep_c, _exchange(send_d), items, uniq,
                     params)


def search_sim(consts, queries, entry_vec, entry_norm, entry_id: int,
               params: EngineParams, geom: EngineGeom, device="cuda"):
    """Single-device simulation of the sharded search: the shard axis
    leads every array. ``queries`` (S, Qs, d) is moved to ``device``;
    ``consts`` must already live there (``pack_for_engine``).

    The round loop runs on the host: before each round it reads one
    boolean ("is any row still searching?") from the device — one host
    sync per round, plus the one that ends the loop. Returns (ids
    (S, Qs, k), dists (S, Qs, k), stats); stats["total_rounds"] is the
    round count per shard (all shards step in lockstep) and
    stats["host_syncs"] the number of those reads.
    """
    dev = resolve_device(device)
    if consts["db"].device.type != dev.type:
        raise ValueError(f"consts live on {consts['db'].device}, the search "
                         f"runs on {dev}: pack_for_engine(packed, device)")
    queries = torch.as_tensor(queries, device=consts["db"].device).float()
    qq = (queries * queries).sum(-1)                   # (S, Qs)
    state = _init_state(queries, qq, entry_vec, entry_norm, entry_id,
                        params)
    spec_w = torch.full(queries.shape[:2], params.spec_width,
                        dtype=torch.int32, device=queries.device)
    t = syncs = 0
    while t < params.search.rounds_cap:
        syncs += 1
        if not bool((~state.done).any()):
            break
        state = _sim_round(state, consts, queries, qq, spec_w, params, geom)
        t += 1
    out_i, out_d, stats = _finalize(state, params.search.k)
    stats["total_rounds"] = torch.full((queries.shape[0],), t,
                                       dtype=torch.int32)
    stats["host_syncs"] = syncs
    return out_i, out_d, stats
