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
shards, and the Gather merge one fused ``merge_unsorted`` launch
(``KernelBackend.merge_gather``).

Hot paths dispatch through ``EngineParams.kernel_mode`` (a
:class:`repro_torch.core.backend.KernelBackend`): phase-B distances
become paged SiN kernel reads grouped by physical page, and the merge
runs the bitonic network — or inline torch ops in ``torch`` mode. All
modes are bit-identical on integer-valued vectors.

Two drivers step the same ``_sim_round``: the one-shot ``search_sim``
and the round-stepper API of the streaming scheduler
(``engine_init / engine_round / engine_admit / engine_retire /
engine_run_chunk / engine_run_chunk_admit``, bundled by
``make_stepper``).

Multi-device (the twin of the reference's ``shard_map`` leg): on an
engine mesh (launch/mesh.py; one process per rank of a
``torch.distributed`` group) rank r of w owns the S / w consecutive
shards from r * S / w, and holds only their consts
(:func:`shard_consts`). ``search_distributed`` and
``make_stepper(mesh=...)`` run the same stages on a rank's own rows: the
exchanges are ``all_to_all_single`` calls, the loop conditions
all-reduced counts, so every rank steps in lockstep, and the stepper's
stages take and return the sim's global state on every rank.

The round loops run on the device, as the reference's
``lax.while_loop``s do: a chunk is K *predicated* rounds
(:func:`_predicated`). Each round computes the loop condition ``go`` as
a device boolean, runs, and keeps its results only where ``go`` holds
(``torch.where`` on every carried value), so a round past the loop's
exit — a dead round — is an exact no-op and the chunk reads nothing
from the device. On a card the chunk is captured once as a CUDA graph
and replayed (core/capture.py); the host reads the device once per
chunk. A dead round still costs a round of device time: the torch
release the port runs on (2.11) has no conditional graph node
(``begin_capture_to_if_node``) to skip it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import capture as cap
from repro_torch.core.backend import KernelBackend
from repro_torch.core.dispatch import (bucket_mask, compute_ranks,
                                       gather_from_buckets,
                                       scatter_to_buckets)
from repro_torch.core.luncsr import PackedIndex, physical_page_of
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.traversal import (dedup_in_round, merge_candidates,
                                        select_expand)
from repro_torch.ft import inject as ftinject
from repro_torch.ft.guard import quarantine_distances
from repro_torch.ft.inject import NEVER, FaultSpec
from repro_torch.utils import (BIG_DIST, ID_SENTINEL, INVALID, bloom_insert,
                               bloom_query, resolve_device, to_device,
                               to_host)

# rounds per search_sim chunk: the host reads one boolean per chunk, and
# the last chunk of a search runs up to SEARCH_CHUNK - 1 dead rounds
SEARCH_CHUNK = 8


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
    gather_vectors: bool = False    # baseline: move vectors, not distances
    payload_bf16: bool = False      # halve the exchange's query bytes:
                                    # bf16 query payloads (the distance
                                    # kernel's bf16-query instantiation)
    kernel_mode: str = "auto"       # hot-path backend: auto|cuda|ref|torch
                                    # (core/backend.py)
    coalesce_qb: int = 8            # per-page query-tile width in kernel
                                    # modes: one page read serves up to
                                    # this many assignments (0 = per-item)
    local_only: bool = False        # routed legs: drop proposals owned by
                                    # other shards, so a slot row traverses
                                    # only its home shard's subgraph
                                    # (core/router.py two-tier search)
    deadline_rounds: int = 0        # force-retire a row once it has aged
                                    # this many serving-clock rounds since
                                    # admission (best-so-far top-k, the
                                    # `truncated` flag set); 0 = NEVER
    guard_nonfinite: bool = False   # quarantine corrupt (NaN/-inf-ish)
                                    # phase-B distances to BIG_DIST and
                                    # count them instead of letting them
                                    # enter the bitonic merge (ft/guard.py)
    faults: FaultSpec | None = None  # deterministic fault plan
                                    # (ft/inject.py): shard kills/delays
                                    # apply at the in-device admission
                                    # chunk's round boundaries, page
                                    # corruption in the phase-B distance
                                    # read. None adds no op.
    store_pages: int = 0            # tiered page store (core/
                                    # pagestore.py): logical pages per
                                    # shard when the phase-B read goes
                                    # through the translation table
                                    # consts["ttab"] into a device frame
                                    # buffer; a non-resident page stalls
                                    # its owner queries for the round.
                                    # 0 = device-resident store, no op
    delta_cap: int = 0              # live index (core/live.py): rows of
                                    # the append-only delta segment that
                                    # retirement brute-force-scans beside
                                    # the main candidate list, after
                                    # masking tombstoned ids. The delta
                                    # and tombstone consts have a fixed
                                    # shape, so inserts, deletes and
                                    # epoch swaps keep the chunk's
                                    # capture. 0 = frozen index, no op

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
    age: torch.Tensor        # (S, Qs) serving-clock rounds since admission
    deadline: torch.Tensor   # (S, Qs) age at which the row is force-retired
    truncated: torch.Tensor  # (S, Qs) bool: retired by its deadline
    items_recv: torch.Tensor     # (S,) items received by this shard's SiN
    pages_unique: torch.Tensor   # (S,) unique page reads (dynamic allocating)
    drops_b: torch.Tensor        # (S,) phase-B overflow drops at this source
    props_sent: torch.Tensor     # (S,) accepted proposals sent by this source
    quarantined: torch.Tensor    # (S,) corrupt distances quarantined to
                                 # BIG_DIST by the guard (guard_nonfinite)
    page_touch: torch.Tensor     # (S, store_pages) bool: logical pages each
                                 # shard served from resident frames since
                                 # the last chunk boundary ((S, 0) untiered)
    page_miss: torch.Tensor      # (S, store_pages) bool: logical pages
                                 # demanded but not resident (the demand
                                 # set of the next chunk boundary)


def _exchange(tree: dict) -> dict:
    """Source-major buckets (S_src, S_dst, ...) -> destination-major."""
    return {k: v.transpose(0, 1) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# Stage functions — each works on all shards (leading axis S) at once.
# ---------------------------------------------------------------------------
def _entry_rows(entry_vec, entry_norm, entry_id):
    """The entry as operands that broadcast against (S, Qs) rows: the
    global entry ((d,) vector, 0-d norm, int id) as it is, per-shard
    entries ((S, d), (S,), (S,): routed legs seed at their home shard's
    medoid) with a row axis after the shard axis."""
    if entry_vec.dim() == 1:
        return entry_vec, entry_norm, entry_id
    return entry_vec[:, None], entry_norm[:, None], entry_id.reshape(-1, 1)


def _init_state(queries, qq, entry_vec, entry_norm, entry_id,
                params: EngineParams) -> EngineState:
    S, Qs = queries.shape[:2]
    L = params.search.L
    dev = queries.device
    entry_vec, entry_norm, entry_id = _entry_rows(entry_vec, entry_norm,
                                                  entry_id)
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
    dl = params.deadline_rounds if params.deadline_rounds > 0 else NEVER
    pz = torch.zeros((S, params.store_pages), dtype=torch.bool, device=dev)
    return EngineState(cand_d, cand_i, cand_e, bloom, z.bool(), z, z, z,
                       torch.full((S, Qs), dl, dtype=torch.int32,
                                  device=dev), z.bool(), zs, zs, zs, zs, zs,
                       pz, pz.clone())


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
                params: EngineParams, geom: EngineGeom, shard0: int = 0):
    """Build proposals, dedup + bloom-filter, bucket phase-B assignments.

    ``spec_w`` (S, Qs) is the per-query speculation width in
    [0, params.spec_width]; prefetch columns at or beyond a query's width
    are masked to INVALID.

    With ``params.local_only`` (routed legs) every proposal owned by
    another shard than the row's own is dropped before ranking and
    bucketing, so a leg's traversal, and all of its phase-B distance
    work, stays on its home shard and an idle shard receives nothing.
    Without it no mask is built: the fan-out stage as it was. The rows
    are shards ``shard0, shard0 + 1, ...`` (a mesh rank's own rows);
    proposals are bucketed over all ``geom.num_shards`` owners.
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
    own = geom.owner(flat_vid.clamp(0, geom.n - 1))
    if params.local_only:
        my_shard = torch.arange(shard0, shard0 + S,
                                device=own.device)[:, None]
        flat_valid = flat_valid & (own == my_shard)
    dest = torch.where(flat_valid, own, 0)
    rank, _ = compute_ranks(dest, flat_valid, geom.num_shards)
    ok = flat_valid & (rank < params.capacity_b)
    drops = (flat_valid & ~ok).sum(-1).to(torch.int32)

    C, S_all = params.capacity_b, geom.num_shards
    send = {
        "vid": scatter_to_buckets(dest, rank, ok, flat_vid, S_all, C,
                                  fill=INVALID),
        "mask": bucket_mask(dest, rank, ok, S_all, C),
    }
    if not params.gather_vectors:
        qidx = torch.arange(Qs, device=props.device).repeat_interleave(M)
        qpay = queries[:, qidx]
        if params.payload_bf16:
            qpay = qpay.bfloat16()
        send["qvec"] = scatter_to_buckets(dest, rank, ok, qpay, S_all, C)
        send["qq"] = scatter_to_buckets(dest, rank, ok, qq[:, qidx], S_all,
                                        C)
    keep = {"dest": dest, "rank": rank, "ok": ok, "props": props,
            "drops": drops}
    return send, keep


def _fd_distance(recv, db, vnorm, blk_perm, params: EngineParams,
                 geom: EngineGeom, ttab=None, shard0: int = 0):
    """Owner SiN: translate id -> physical page/slot, compute distances.

    In gather_vectors mode returns the raw vectors instead (the
    baseline). Also counts page-buffer statistics per shard: unique
    pages (dynamic allocating shares a page read across assignments) vs
    raw items. A fault plan with page corruption rewrites the distances
    of its bad (logical) pages (salted by each owner shard) to garbage,
    exactly as damaged media would, on every visit; the baseline is
    exempt. The owner rows are shards ``shard0, shard0 + 1, ...`` (the
    salt), each receiving from all ``S_src`` source shards.

    With the tiered page store (``params.store_pages > 0``) ``db`` /
    ``vnorm`` are the device frame buffers (S, P_dev, ...) and ``ttab``
    the (S, store_pages) translation table: pages clamp to the store's
    page count, the read goes through
    :meth:`KernelBackend.translated_item_distances`, a ``"miss"`` lane
    rides the reply so the requester can stall the queries that demanded
    a cold page, and the stage also returns each shard's page touch and
    miss bitmaps (S, store_pages).
    """
    vid, mask = recv["vid"], recv["mask"]              # (S, S_src, C_B)
    S, S_src, C = vid.shape
    flat_vid = vid.reshape(S, -1).clamp(0, geom.n - 1)
    flat_mask = mask.reshape(S, -1)
    npages = params.store_pages or db.shape[1]
    ppage = geom.phys_page(flat_vid, blk_perm).clamp(0, npages - 1)
    slot = flat_vid % geom.page_size

    items = flat_mask.sum(-1).to(torch.int32)
    sorted_pages = torch.sort(torch.where(flat_mask, ppage, 2**30),
                              dim=-1).values
    first = torch.ones_like(flat_mask)
    first[:, 1:] = sorted_pages[:, 1:] != sorted_pages[:, :-1]
    uniq = (first & (sorted_pages != 2**30)).sum(-1).to(torch.int32)

    if params.gather_vectors:
        if params.store_pages:
            raise NotImplementedError(
                "the gather_vectors baseline moves raw vectors, not page "
                "reads: it has no tiered page store")
        srow = torch.arange(S, device=vid.device)[:, None]
        v = db[srow, ppage, slot].float()                  # (S, S*C, d)
        vn = vnorm[srow, ppage, slot]
        return {"vec": torch.where(flat_mask[..., None], v, 0.0
                                   ).reshape(S, S_src, C, -1),
                "vn": torch.where(flat_mask, vn, 0.0).reshape(S, S_src, C)
                }, items, uniq
    args = (ppage, slot, flat_mask, recv["qvec"].reshape(S, S_src * C, -1),
            recv["qq"].reshape(S, -1), db, vnorm)
    if params.store_pages:
        dist, resident = params.backend.translated_item_distances(ttab,
                                                                   *args)
    else:
        dist = params.backend.item_distances(*args)
    if params.faults is not None and params.faults.any_corrupt:
        shard = torch.arange(shard0, shard0 + S, device=vid.device)[:, None]
        bad = ftinject.bad_page_mask(params.faults, ppage, shard)
        dist = torch.where(bad & flat_mask,
                           ftinject.corrupt_value(params.faults), dist)
    if not params.store_pages:
        return {"dist": dist.reshape(S, S_src, C)}, items, uniq
    missed = flat_mask & ~resident

    def bitmap(hit):
        # masked lanes scatter into a spill column that is sliced off
        ext = torch.zeros((S, npages + 1), dtype=torch.bool,
                          device=vid.device)
        return ext.scatter_(-1, torch.where(hit, ppage, npages),
                            True)[:, :npages]

    return ({"dist": dist.reshape(S, S_src, C),
             "miss": missed.reshape(S, S_src, C)},
            items, uniq, bitmap(flat_mask & resident), bitmap(missed))


def _fe_merge(state: EngineState, keep_a, keep_c, recv_d, items, uniq,
              queries, qq, params: EngineParams, page_touch=None,
              page_miss=None):
    """Requester: recover distances, bloom-insert, merge, re-terminate.

    The gather_vectors baseline computes its distances here, from the
    returned vectors, in plain torch (the reference computes them
    outside any kernel too). With ``guard_nonfinite`` corrupt distances
    become worthless-but-harmless candidates: they still count as
    accepted proposals (the read happened), but a BIG_DIST entry never
    displaces a real one in the merge.

    Tiered store (``params.store_pages > 0``): a query with any accepted
    assignment on a non-resident page (the reply's ``"miss"`` lane)
    **stalls**: its whole round is restored like a ``done`` row's
    (candidates, bloom, rounds, n_dist), so it retries the same round
    after the boundary's demand fetch; ``age`` still advances.
    ``page_touch`` / ``page_miss`` are the round's bitmaps, OR-ed into
    the state for the boundary.
    """
    L = params.search.L
    props = keep_c["props"]                            # (S, Qs, M)
    S, Qs, M = props.shape
    gather = [keep_c["dest"], keep_c["rank"], keep_c["ok"],
              params.capacity_b]
    if params.gather_vectors:
        vec = gather_from_buckets(recv_d["vec"], *gather)  # (S, Qs*M, d)
        vn = gather_from_buckets(recv_d["vn"], *gather)
        qidx = torch.arange(Qs, device=props.device).repeat_interleave(M)
        qv = (queries[:, qidx].float() * vec).sum(-1)
        dist = (qq[:, qidx] - 2.0 * qv) + vn
    else:
        dist = gather_from_buckets(recv_d["dist"], *gather)
    accepted = keep_c["ok"].reshape(S, Qs, M)
    dist = torch.where(accepted, dist.reshape(S, Qs, M), BIG_DIST)
    keep, acc_eff = state.done, accepted
    p_touch, p_miss = state.page_touch, state.page_miss
    if params.store_pages:
        # a live row always has an unexpanded candidate, so a stalled
        # row is never re-terminated by the done update below
        missf = gather_from_buckets(recv_d["miss"], *gather)
        stall = (missf.reshape(S, Qs, M) & accepted).any(-1) & ~state.done
        keep = state.done | stall
        acc_eff = accepted & ~stall[..., None]
        p_touch, p_miss = p_touch | page_touch, p_miss | page_miss
    quarantined = state.quarantined
    if params.guard_nonfinite:
        dist, quar = quarantine_distances(dist, acc_eff, BIG_DIST,
                                          dim=(1, 2))
        quarantined = quarantined + quar

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
    n_dist = state.n_dist + torch.where(worked, acc_eff.sum(-1), 0).int()
    done = state.done | ~((~cand_e) & (cand_i != ID_SENTINEL)).any(-1)
    return EngineState(
        cand_d, cand_i, cand_e, bloom, done, rounds, n_dist,
        state.age, state.deadline, state.truncated,
        state.items_recv + items, state.pages_unique + uniq,
        state.drops_b + keep_c["drops"],
        state.props_sent + acc_eff.sum((1, 2)).int(), quarantined,
        p_touch, p_miss)


def _finalize(state: EngineState, k: int):
    out_i = torch.where(state.cand_i[..., :k] != ID_SENTINEL,
                        state.cand_i[..., :k], INVALID)
    stats = {
        "rounds": state.rounds, "n_dist": state.n_dist,
        "items_recv": state.items_recv, "pages_unique": state.pages_unique,
        "drops_b": state.drops_b, "props_sent": state.props_sent,
        "truncated": state.truncated, "quarantined": state.quarantined,
    }
    return out_i, state.cand_d[..., :k], stats


def _finalize_live(state: EngineState, queries, tombs, delta_vec,
                   delta_norm, delta_live, k: int):
    """Live-index retire: mask tombstones, merge the delta segment.

    Three steps, each chosen so a zero-churn session stays bit-identical
    to :func:`_finalize`:

      1. tombstoned candidates are **stable-partitioned** to the back of
         the full length-L list (all-False flags: the identity
         permutation) and overwritten with (ID_SENTINEL, BIG_DIST), so a
         leaked tombstone can never survive in the first k;
      2. the delta segment is brute-force scanned with the same
         mul+reduce distance expression as :func:`_init_state`; dead
         rows score BIG_DIST, live rows get global ids ``capacity +
         row``;
      3. [main k | delta] is merged by a **stable** sort on distance:
         main is already sorted ascending and wins ties, so an at-rest
         delta (all BIG_DIST) reproduces the frozen output exactly.

    Both sorts are ``torch.sort(stable=True)``: ties keep their position,
    as the reference's ``jnp.argsort(stable=True)`` does (the bitonic
    kernels break ties by id, which would reorder equal distances). The
    first sorts the bool ``dead`` mask itself."""
    ids = state.cand_i                                      # (S, Qs, L)
    cap = tombs.shape[0]
    dead = tombs[ids.long().clamp(0, cap - 1)] & (ids != ID_SENTINEL)
    dd, order = torch.sort(dead, dim=-1, stable=True)
    ci = ids.gather(-1, order)
    cd = state.cand_d.gather(-1, order)
    main_i = torch.where(dd, ID_SENTINEL, ci)[..., :k]
    main_d = torch.where(dd, BIG_DIST, cd)[..., :k]

    q = queries.float()
    qq = (q * q).sum(-1)
    dn = delta_vec.shape[0]
    d_d = (qq[..., None] - 2.0 * (q[..., None, :] * delta_vec.float()).sum(-1)
           + delta_norm)
    d_d = torch.where(delta_live, d_d, BIG_DIST)
    d_i = torch.where(delta_live,
                      cap + torch.arange(dn, dtype=torch.int32,
                                         device=ids.device), ID_SENTINEL)
    d_i = d_i.expand(ids.shape[:-1] + (dn,))

    all_d = torch.cat([main_d, d_d], -1)
    all_i = torch.cat([main_i, d_i.to(main_i.dtype)], -1)
    out_d, ord2 = torch.sort(all_d, dim=-1, stable=True)
    out_i = all_i.gather(-1, ord2[..., :k])
    out_i = torch.where(out_i != ID_SENTINEL, out_i, INVALID)
    stats = {
        "rounds": state.rounds, "n_dist": state.n_dist,
        "items_recv": state.items_recv, "pages_unique": state.pages_unique,
        "drops_b": state.drops_b, "props_sent": state.props_sent,
        "truncated": state.truncated, "quarantined": state.quarantined,
    }
    return out_i, out_d[..., :k], stats


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------
#: the consts a packed index gives the engine (a live index's epoch swap
#: rewrites them in place)
MAIN_CONST_KEYS = ("db", "vnorm", "adj", "pref", "blk_perm")


def pack_for_engine(packed: PackedIndex, device="cuda", *,
                    host_pages: bool = False):
    """PackedIndex -> (consts dict of tensors on ``device`` with a leading
    shard axis, geom, (entry_vec, entry_norm, entry_id)).

    ``host_pages`` keeps the vector pages (``db`` / ``vnorm``) in host
    memory: the build of a tiered session, whose ``PageStore`` takes them
    as its cold tier and puts only its frame buffers on the device."""
    dev = resolve_device(device)
    geom = EngineGeom.from_packed(packed)
    consts = {name: torch.as_tensor(
        getattr(packed, name),
        device="cpu" if host_pages and name in ("db", "vnorm") else dev)
        for name in MAIN_CONST_KEYS}
    # locate the entry vertex's physical position on its shard
    s, p, sl = (int(x[0]) for x in physical_page_of(packed, [packed.entry]))
    entry = (consts["db"][s, p, sl].float().to(dev),
             consts["vnorm"][s, p, sl].to(dev), int(packed.entry))
    return consts, geom, entry


def _sim_round(state: EngineState, consts, queries, qq, spec_w,
               params: EngineParams, geom: EngineGeom,
               exchange=_exchange, shard0: int = 0) -> EngineState:
    """One engine round over the state's shard rows (shards ``shard0``
    on): the sim driver's are all of them, and its exchanges swap the
    bucket axes; a mesh rank's are its own, and its exchanges are
    all-to-alls (:func:`_mesh_exchange`)."""
    send_a, keep_a = _fa_select(state, params, geom)
    send_b = _fb_adjacency(exchange(send_a), consts["adj"], consts["pref"],
                           params, geom)
    send_c, keep_c = _fc_propose(state, keep_a, exchange(send_b), queries,
                                 qq, spec_w, params, geom, shard0)
    # tiered store: stage D also returns the round's page bitmaps
    send_d, items, uniq, *bitmaps = _fd_distance(
        exchange(send_c), consts["db"], consts["vnorm"], consts["blk_perm"],
        params, geom, consts.get("ttab"), shard0)
    return _fe_merge(state, keep_a, keep_c, exchange(send_d), items, uniq,
                     queries, qq, params, *bitmaps)


def exchange_buckets(consts, queries, entry_vec, entry_norm, entry_id: int,
                     params: EngineParams, geom: EngineGeom) -> list:
    """The bucket tensors that one eager round from a fresh state hands
    to its four exchanges (phases A to D): per exchange, ``bytes``, their
    total size, and ``slots``, the (source, destination, capacity) slots
    they hold. Their shapes are static, so the numbers hold at any
    occupancy; the exchange itself is a view and copies nothing."""
    queries = torch.as_tensor(queries, device=consts["db"].device).float()
    out = []

    def tally(tree):
        out.append({"bytes": sum(v.nbytes for v in tree.values()),
                    "slots": math.prod(next(iter(tree.values())).shape[:3])})
        return _exchange(tree)

    state = engine_init(consts, queries, entry_vec, entry_norm, entry_id,
                        params, geom)
    _sim_round(state, consts, queries, _qq(queries),
               _widths(params.spec_width, queries.shape[:2], queries.device),
               params, geom, exchange=tally)
    return out


# ---------------------------------------------------------------------------
# Multi-device: one process per rank of a torch.distributed group
# ---------------------------------------------------------------------------
def _all_sum(mesh, x) -> torch.Tensor:
    """``x`` summed over every rank (a new tensor)."""
    x = x.clone()
    dist.all_reduce(x, group=mesh.group)
    return x


def _all_gather(mesh, tree, dim: int = 0):
    """Every rank's tensors of ``tree`` concatenated along ``dim`` in
    rank order. The tensors share their extent along ``dim`` (this
    rank's rows): they travel packed, one all-gather per dtype."""
    rows = [x.movedim(dim, 0) for x in cap.tree_leaves(tree)]
    by_dtype: dict = {}
    for i, x in enumerate(rows):
        by_dtype.setdefault(x.dtype, []).append(i)
    out = [None] * len(rows)
    for idx in by_dtype.values():
        n = rows[idx[0]].shape[0]
        flat = [rows[i].reshape(n, -1) for i in idx]
        width = [f.shape[1] for f in flat]
        send = torch.cat(flat, 1)
        recv = send.new_empty((mesh.world * n, send.shape[1]))
        if send.numel():
            dist.all_gather_into_tensor(recv, send, group=mesh.group)
        for i, part in zip(idx, recv.split(width, -1)):
            x = part.reshape((mesh.world * n,) + tuple(rows[i].shape[1:]))
            out[i] = x if dim == 0 else x.movedim(0, dim).contiguous()
    it = iter(out)
    return cap.tree_map(lambda _: next(it), tree)


def _all_to_all(mesh, x) -> torch.Tensor:
    """Source-major buckets ``(S_loc, S, ...)`` (this rank's source
    shards, every destination) -> destination-major ``(S_loc, S, ...)``
    (this rank's destination shards, every source): the twin of
    ``lax.all_to_all(x, axis, 0, 0)``, one ``all_to_all_single``."""
    Sl, S = x.shape[:2]
    w, rest = S // Sl, tuple(x.shape[2:])
    # (src local, dst rank, dst local, ...) -> (dst rank, dst local,
    # src local, ...): rank i's chunk holds its destination rows
    send = x.reshape((Sl, w, Sl) + rest).movedim(0, 2).contiguous()
    recv = torch.empty_like(send)
    if send.numel():
        dist.all_to_all_single(recv, send, group=mesh.group)
    # (src rank, dst local, src local, ...) -> (dst local, S, ...)
    return recv.transpose(0, 1).reshape((Sl, S) + rest)


def _mesh_exchange(mesh):
    """The exchange of a mesh round: one all-to-all per bucket tensor."""
    def exchange(tree: dict) -> dict:
        return {k: _all_to_all(mesh, v) for k, v in tree.items()}
    return exchange


class _Part:
    """The shard rows a stage works on. On the sim driver (``mesh``
    None) every row, and every method is the identity or the plain
    reduction, so the sim's ops are unchanged. On a mesh, this rank's
    ``S / world`` consecutive rows from ``lo``: a stage takes the global
    ``(S, ...)`` tensors, slices its rows (:meth:`local`), works on
    them, and all-gathers the results (:meth:`gather`); the loop
    conditions and traces are all-reduced, so every rank steps in
    lockstep."""

    def __init__(self, num_shards: int, mesh=None):
        self.mesh = mesh
        if mesh is None:
            self.lo, self.n = 0, num_shards
            self.exchange = _exchange
        else:
            self.lo = mesh.shard0(num_shards)
            self.n = mesh.shards_per_rank(num_shards)
            self.exchange = _mesh_exchange(mesh)

    def key(self) -> tuple:
        """The capture-key part: a mesh program is one rank's of one
        process group (a graph holds that group's collectives)."""
        if self.mesh is None:
            return ()
        return (self.mesh.world, self.mesh.rank, self.mesh.generation)

    def check(self, consts):
        """``consts``, which on a mesh must hold this rank's shards
        only (:func:`shard_consts`)."""
        if self.mesh is not None and consts["db"].shape[0] != self.n:
            raise ValueError(
                f"consts hold {consts['db'].shape[0]} shards, rank "
                f"{self.mesh.rank} of {self.mesh.world} owns {self.n}: "
                f"pass shard_consts(consts, mesh)")
        return consts

    def warm(self, device) -> None:
        if self.mesh is not None:
            self.mesh.warm(device)

    def local(self, tree, dim: int = 0):
        if self.mesh is None:
            return tree
        return cap.tree_map(lambda x: x.narrow(dim, self.lo, self.n), tree)

    def local_entry(self, entry):
        """Per-shard entries ((S, d) vectors) sliced; a global one kept."""
        if self.mesh is None or entry[0].dim() == 1:
            return entry
        return self.local(tuple(entry))

    def gather(self, tree, dim: int = 0):
        return tree if self.mesh is None else _all_gather(self.mesh, tree,
                                                          dim)

    def total(self, x):
        """``x`` summed over the ranks (the traces of the rows' counts)."""
        return x if self.mesh is None else _all_sum(self.mesh, x)

    def any(self, *masks) -> tuple:
        """``m.any()`` over every rank's rows, per mask: one all-reduce
        of their counts on a mesh."""
        if self.mesh is None:
            return tuple(m.any() for m in masks)
        counts = torch.stack([m.sum() for m in masks]).to(torch.int64)
        return tuple(_all_sum(self.mesh, counts) > 0)

    def free_below(self, free):
        """(free rows on lower ranks, free rows on every rank): the flat
        admission's global row-major free ranks start at the first."""
        counts = _all_gather(self.mesh, free.sum().reshape(1))
        lower = torch.arange(self.mesh.world, device=free.device) < \
            self.mesh.rank
        return torch.where(lower, counts, 0).sum(), counts.sum()


def shard_consts(consts, mesh):
    """This rank's shards of ``pack_for_engine``'s consts (every shard's):
    rows ``[shard0, shard0 + S / world)`` of ``db``, ``vnorm``, ``adj``,
    ``pref`` and ``blk_perm``, copied once; at world 1 the consts
    themselves. Every mesh entry point takes consts in this form, and
    their addresses key the captured chunks: slice once, keep the
    result."""
    S = consts["db"].shape[0]
    lo, n = mesh.shard0(S), mesh.shards_per_rank(S)
    if n == S:
        return consts
    return {k: v[lo:lo + n].clone() if k in MAIN_CONST_KEYS else v
            for k, v in consts.items()}


def _mesh_refusals(params: EngineParams) -> None:
    """What the mesh leg does not carry, as the reference's refuses it."""
    if params.store_pages:
        raise NotImplementedError(
            "tiered page store (store_pages > 0) runs on the sim driver "
            "only")
    if params.delta_cap:
        raise NotImplementedError(
            "the live index (delta_cap > 0) runs on the sim driver only")


def _keep(go, new, old):
    """``new`` where the round's condition ``go`` (a 0-d bool) holds,
    ``old`` elsewhere, over a tree of tensors."""
    if isinstance(old, torch.Tensor):
        return torch.where(go, new, old)
    vals = [_keep(go, n, o) for n, o in zip(new, old)]
    return old._make(vals) if hasattr(old, "_make") else type(old)(vals)


_EVERY_ROUND = 0


@contextlib.contextmanager
def every_round():
    """While open, a predicated chunk on the CPU runs all its K rounds,
    dead ones included, as the card does, instead of stopping at its
    first dead round. The results are the same; the op recorders
    (launch/opanalysis.py ``OpStream``) open it so that their counts are
    the card's."""
    global _EVERY_ROUND
    _EVERY_ROUND += 1
    try:
        yield
    finally:
        _EVERY_ROUND -= 1


def _predicated(carry, cond, body, K: int):
    """K rounds of ``body`` under ``cond``: each round computes ``go =
    cond(carry)`` on the device, runs, and keeps its results only where
    ``go`` holds, so a round past the loop's exit is an exact no-op. No
    round reads the device. The condition never turns true again once
    false (a dead round changes nothing it reads), so on the CPU, where
    reading it costs nothing, the chunk stops after its first dead
    round, unless :func:`every_round` is open. On a mesh ``cond`` is
    all-reduced, so every rank stops at the same round and their
    collectives stay paired."""
    early_exit = _EVERY_ROUND == 0
    for _ in range(K):
        go = cond(carry)
        carry = _keep(go, body(carry), carry)
        if early_exit and not go.is_cuda and not bool(go):
            break
    return carry


def _consts_key(consts) -> tuple:
    return cap.tensor_ptrs(*(consts[k] for k in sorted(consts)))


def _search_chunk(consts, state: EngineState, t, queries,
                  params: EngineParams, geom: EngineGeom, K: int,
                  part: _Part):
    """K predicated rounds of the one-shot search under the reference's
    loop condition ``(~done).any() & (t < rounds_cap)`` (on a mesh the
    active rows are all-reduced, the reference's ``psum``). Returns
    (state, t, the condition after the chunk)."""
    qq = _qq(queries)
    spec_w = torch.full(queries.shape[:2], params.spec_width,
                        dtype=torch.int32, device=queries.device)

    def cond(c):
        return part.any(~c[0].done)[0] & (c[1] < params.search.rounds_cap)

    def body(c):
        return (_sim_round(c[0], consts, queries, qq, spec_w, params, geom,
                           part.exchange, part.lo), c[1] + 1)

    state, t = _predicated((state, t), cond, body, K)
    return state, t, cond((state, t))


def _search(consts, queries, entry_vec, entry_norm, entry_id,
            params: EngineParams, geom: EngineGeom, part: _Part, device,
            capture: bool):
    """The one-shot driver of :func:`search_sim` and
    :func:`search_distributed` over ``part``'s rows (their docs)."""
    dev = resolve_device(device)
    consts = part.check(consts)
    if consts["db"].device.type != dev.type:
        raise ValueError(f"consts live on {consts['db'].device}, the search "
                         f"runs on {dev}: pack_for_engine(packed, device)")
    queries = torch.as_tensor(queries, device=consts["db"].device).float()
    S = geom.num_shards
    if queries.shape[0] != S:
        raise ValueError(f"queries lead with {queries.shape[0]} shards, "
                         f"the index has {S}")
    part.warm(queries.device)
    queries = part.local(queries)
    state = _init_state(queries, _qq(queries), entry_vec, entry_norm,
                        entry_id, params)
    t = torch.zeros((), dtype=torch.int32, device=queries.device)
    K = SEARCH_CHUNK
    name = "search_sim" if part.mesh is None else "search_distributed"
    key = (params, geom, K, _consts_key(consts), *part.key())

    def chunk(*a):
        return _search_chunk(consts, EngineState(*a[:-2]), a[-2], a[-1],
                             params, geom, K, part)

    syncs = 0
    while True:
        state, t, go = cap.CACHE.run(name, chunk, key, (*state, t, queries),
                                     K, capture)
        go, rounds = to_host(go, t)
        syncs += 1
        if not go:
            break
    # the chunk's outputs are the cache entry's buffers: copy them out
    out_i, out_d, stats = cap.tree_map(
        torch.clone, part.gather(_finalize(state, params.search.k)))
    stats["total_rounds"] = torch.full((S,), int(rounds), dtype=torch.int32)
    stats["host_syncs"] = syncs
    return out_i, out_d, stats


def search_sim(consts, queries, entry_vec, entry_norm, entry_id: int,
               params: EngineParams, geom: EngineGeom, device="cuda",
               capture: bool = True):
    """Single-device simulation of the sharded search: the shard axis
    leads every array. ``queries`` (S, Qs, d) is moved to ``device``;
    ``consts`` must already live there (``pack_for_engine``).

    The reference's ``lax.while_loop`` as chunks of SEARCH_CHUNK
    predicated rounds (captured once and replayed on a card): after each
    chunk the host reads the loop condition and the round counter in one
    transfer, and stops when every row is done or ``rounds_cap`` is
    reached. ``capture=False`` runs the chunks eagerly on the card (the
    proof that captured and uncaptured runs agree). Returns (ids
    (S, Qs, k), dists (S, Qs, k), stats); stats["total_rounds"] is the
    round count per shard (all shards step in lockstep) and
    stats["host_syncs"] the number of chunks (one read each).
    """
    return _search(consts, queries, entry_vec, entry_norm, entry_id, params,
                   geom, _Part(geom.num_shards), device, capture)


def search_distributed(consts, queries, entry_vec, entry_norm, entry_id,
                       params: EngineParams, geom: EngineGeom, mesh,
                       device="cuda", capture: bool = True):
    """:func:`search_sim` over an engine mesh (launch/mesh.py), the twin
    of the reference's ``shard_map`` driver: every rank of the group
    calls it with the same global ``queries`` (S, Qs, d) and its own
    shards' ``consts`` (:func:`shard_consts`); each runs its own rows,
    and the four exchanges of a round are all-to-alls. Chunks as in
    :func:`search_sim` (captured once per key on a card, the collectives
    inside the graph); the loop condition is the all-reduced active
    count, so every rank steps in lockstep. Returns global (ids (S, Qs,
    k), dists, stats) on every rank, as :func:`search_sim` does."""
    _mesh_refusals(params)
    return _search(consts, queries, entry_vec, entry_norm, entry_id, params,
                   geom, _Part(geom.num_shards, mesh), device, capture)


# ---------------------------------------------------------------------------
# Dynamic speculation — the pure per-round width rule.
# ---------------------------------------------------------------------------
def spec_update(spec_w, hit, peak, accepted, worked, cfg,
                pages_delta=None, phit=None, ppeak=None):
    """One controller step of the paper's dynamic speculative search
    (§V-B), in tensor ops so it runs both on the host mirror
    (``SpecController.update``) and in :func:`engine_run_chunk`'s round
    loop.

    ``spec_w`` must be the widths *used* in the round that produced
    ``accepted``: the per-query acceptance rate

        hit_q = accepted_q / (W * (max_degree + spec_w_used_q))

    is smoothed (EMA) and compared with its own running peak; the width
    follows the normalized rate linearly between ``floor`` and ``ceil``.
    ``pages_delta`` ((S,) unique page reads of the round, per shard)
    feeds a second rate, accepted / pages, tracked the same way and
    blended in with weight ``page_w``; ``page_w = 0`` multiplies by
    exactly 1.0. ``cfg`` is ``(spec_max, W, max_degree, floor, ceil,
    ema[, page_w])``. Returns ``(spec_w, hit, peak, phit, ppeak)``.

    Every op is the reference's f32 op in the reference's order: the
    widths are ``round`` (half to even) of an f32 fraction, so one bit
    flips a width at a .5 boundary. Scalar-only arithmetic runs in
    numpy f32, and a division by a scalar divides by a filled tensor
    (CUDA turns ``tensor / scalar`` into a multiply by the reciprocal).
    """
    spec_max, w_sel, max_degree, floor, ceil, ema = cfg[:6]
    page_w = np.float32(cfg[6]) if len(cfg) > 6 else np.float32(0.0)
    floor, ceil, ema = np.float32(floor), np.float32(ceil), np.float32(ema)
    one_m_ema = np.float32(1.0) - ema
    span = float(np.maximum(ceil - floor, np.float32(1e-9)))
    served = int(w_sel) * (int(max_degree) + spec_w)
    h = accepted.float() / served.clamp_min(1).float()
    first = worked & (hit < 0)
    upd = worked & ~first
    hit = torch.where(first, h, torch.where(
        upd, float(ema) * h + float(one_m_ema) * hit, hit))
    peak = torch.maximum(peak, hit)
    ratio = hit / peak.clamp_min(1e-9)
    frac = ((ratio - float(floor)) / torch.full_like(ratio, span)
            ).clamp(0.0, 1.0)
    if phit is None:
        phit = torch.full_like(hit, -1.0)
        ppeak = torch.zeros_like(peak)
    if pages_delta is not None:
        pd = pages_delta.reshape(pages_delta.shape + (1,) * (
            hit.dim() - pages_delta.dim())).expand(hit.shape)
        p = accepted.float() / pd.clamp_min(1).float()
        first_p = worked & (phit < 0)
        upd_p = worked & ~first_p
        phit = torch.where(first_p, p, torch.where(
            upd_p, float(ema) * p + float(one_m_ema) * phit, phit))
        ppeak = torch.maximum(ppeak, phit)
        ratio_p = phit / ppeak.clamp_min(1e-9)
        frac_p = ((ratio_p - float(floor)) / torch.full_like(ratio_p, span)
                  ).clamp(0.0, 1.0)
        frac = frac * (float(np.float32(1.0) - page_w)
                       + float(page_w) * frac_p)
    width = torch.round(float(spec_max) * frac).to(torch.int32)
    return torch.where(worked, width, spec_w), hit, peak, phit, ppeak


# ---------------------------------------------------------------------------
# Round-stepper API — the streaming scheduler's engine surface.
#
# ``engine_init`` / ``engine_round`` / ``engine_admit`` / ``engine_retire``
# work on an EngineState whose shard axis leads every tensor, so the state
# persists across calls: the host loop (core/scheduler.py) owns the round
# counter, retires finished slot rows and refills them with fresh queries.
# ``engine_run_chunk`` runs up to K rounds per call (speculation widths
# stepping per round); ``engine_run_chunk_admit`` also seats arrived
# queries from a device-side pending queue at every round boundary. As
# the reference's device ``lax.while_loop`` does, a chunk runs K
# predicated rounds (:func:`_predicated`) and returns without reading
# the device: ``steps``, the traces and the cursor stay device tensors
# that the host reads with the chunk boundary's one transfer. On a card
# each chunk program is captured once and replayed (core/capture.py).
# ---------------------------------------------------------------------------
class EngineStepper(NamedTuple):
    """(init, round, admit, retire, run_chunk, run_chunk_admit) bound to
    static params/geom; ``round_chunk`` is the K the chunk stages clamp
    their budgets to."""

    init: callable       # (consts, queries, evec, enorm, eid) -> EngineState
    round: callable      # (consts, state, queries, spec_w) -> EngineState
    admit: callable      # (state, queries, admit_mask, new_q, evec, enorm,
                         #  eid) -> (EngineState, queries')
    retire: callable     # (state) -> (ids, dists, per-slot stats)
    run_chunk: callable  # see engine_run_chunk
    round_chunk: int = 1
    run_chunk_admit: callable = None   # see engine_run_chunk_admit


def _qq(queries):
    return (queries * queries).sum(-1)


def _widths(spec_w, shape, device):
    """A scalar width or (S, Qs) widths -> (S, Qs) int32."""
    if isinstance(spec_w, torch.Tensor):
        return spec_w.to(torch.int32).expand(shape)
    return torch.full(shape, int(spec_w), dtype=torch.int32, device=device)


def engine_init(consts, queries, entry_vec, entry_norm, entry_id,
                params: EngineParams, geom: EngineGeom) -> EngineState:
    """Fresh state for an (S, Qs, d) slot pool, as one-shot init does:
    every row starts at the global entry vertex ((d,) ``entry_vec``,
    int ``entry_id``) or at its shard's entry (per-shard ``(S, d)``,
    ``(S,)``, ``(S,)``: routed legs seed at their home shard's
    medoid)."""
    del consts, geom
    return _init_state(queries, _qq(queries), entry_vec, entry_norm,
                       entry_id, params)


def engine_round(consts, state: EngineState, queries, spec_w,
                 params: EngineParams, geom: EngineGeom) -> EngineState:
    """One Allocating -> Searching -> Gathering round. ``spec_w`` is the
    per-query speculation width: a scalar or (S, Qs) int32 in
    [0, params.spec_width]."""
    return _sim_round(state, consts, queries, _qq(queries),
                      _widths(spec_w, queries.shape[:2], queries.device),
                      params, geom)


def _admit_rows(state: EngineState, queries, admit_mask, new_q,
                entry_vec, entry_norm, entry_id, params: EngineParams):
    """The slot-refill math, shared by the host-side :func:`engine_admit`
    and the admission stage of :func:`engine_run_chunk_admit`: rows where
    ``admit_mask`` restart from the entry vertex with the vectors in
    ``new_q``, every per-query field rebuilt by the same ``_init_state``
    math as the one-shot driver; the shard counters pass through."""
    q = torch.where(admit_mask[..., None], new_q, queries)
    fresh = _init_state(q, _qq(q), entry_vec, entry_norm, entry_id, params)

    def rows(cur, new):
        m = admit_mask.reshape(admit_mask.shape
                               + (1,) * (cur.dim() - admit_mask.dim()))
        return torch.where(m, new, cur)

    per_query = EngineState._fields.index("items_recv")
    return EngineState(*(rows(cur, new) for cur, new in
                         zip(state[:per_query], fresh[:per_query])),
                       *state[per_query:]), q


def engine_admit(state: EngineState, queries, admit_mask, new_q,
                 entry_vec, entry_norm, entry_id,
                 params: EngineParams, geom: EngineGeom):
    """Refill freed slots (slot compaction by replacement): a reused slot
    is bit-identical to a fresh one; the shard-cumulative counters
    (items_recv, pages_unique, drops_b, props_sent) are kept. The entry
    may be per-shard, as in :func:`engine_init`. Returns the new state
    and the updated (S, Qs, d) query buffer."""
    del geom
    return _admit_rows(state, queries, admit_mask, new_q, entry_vec,
                       entry_norm, entry_id, params)


def engine_retire(state: EngineState, k: int):
    """Per-slot results + stats; the host slices the retiring rows."""
    return _finalize(state, k)


#: consts keys a live index adds next to db/vnorm/adj/pref/blk_perm.
LIVE_CONST_KEYS = ("tombs", "delta_vec", "delta_norm", "delta_live")


def engine_retire_live(state: EngineState, queries, tombs, delta_vec,
                       delta_norm, delta_live, k: int):
    """:func:`engine_retire` through :func:`_finalize_live`: tombstones
    masked, the delta segment merged."""
    return _finalize_live(state, queries, tombs, delta_vec, delta_norm,
                          delta_live, k)


def _chunk_round(carry, round_fn, rounds_cap: int, dynamic: bool,
                 spec_cfg, stall=None):
    """One in-chunk round, shared by both chunk drivers: record the
    per-round traces at index j (a device scalar; the write index is
    clamped so a dead round at j == K writes in bounds, and its result
    is discarded), step the round, park rows reaching the per-query
    round cap at the boundary the per-round scheduler would retire them,
    age every row live at entry and force-retire those at their
    deadline (truncated; a row that converged this very round is not),
    and — in dynamic mode — step the widths with the widths used and the
    round's unique-page delta (:func:`spec_update`).

    ``stall`` (None, or a bool tensor broadcastable against ``done``)
    marks rows whose shard is not serving this round (a fault plan's
    kill or delay): they are parked for the round — no phase work, no
    merge, no ``rounds`` advance — and un-parked afterwards with their
    traversal state intact. The serving clock still ages every live row,
    stalled or not, so the deadline retires rows a dead shard will never
    finish."""
    st, sw, hi, pk, phi, ppk, prev_nd, prev_pg, j, lc, ws = carry
    worked = ~st.done
    at = j.clamp(max=lc.shape[0] - 1).long().reshape(1)
    lc = lc.index_copy(0, at, worked.sum().int().reshape(1))
    ws = ws.index_copy(0, at, torch.where(worked, sw, 0).sum().int()
                       .reshape(1))
    if stall is None:
        st = round_fn(st, sw)
    else:
        pre_done = st.done
        st = round_fn(st._replace(done=st.done | stall), sw)
        st = st._replace(done=torch.where(stall, pre_done, st.done))
    st = st._replace(done=st.done | (st.rounds >= rounds_cap))
    age = st.age + worked.int()
    hit = ~st.done & (age >= st.deadline)
    st = st._replace(age=age, done=st.done | hit,
                     truncated=st.truncated | hit)
    if dynamic:
        sw, hi, pk, phi, ppk = spec_update(
            sw, hi, pk, st.n_dist - prev_nd, worked, spec_cfg,
            st.pages_unique - prev_pg, phi, ppk)
    return (st, sw, hi, pk, phi, ppk, st.n_dist, st.pages_unique, j + 1,
            lc, ws)


def _scalar(x, dtype, device) -> torch.Tensor:
    """A host number or a device scalar -> a 0-d tensor on ``device``
    (a fill, not a copy from host memory)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).reshape(())
    return torch.full((), x, dtype=dtype, device=device)


def _run_chunk(consts, state: EngineState, queries, spec_state, budget,
               stop, spec_cfg, params: EngineParams, geom: EngineGeom,
               K: int, dynamic: bool, part: _Part):
    """The program of :func:`engine_run_chunk` (device tensors only): on
    a mesh, this rank's rows, gathered at the end."""
    state, queries, spec_state = part.local((state, queries, spec_state))
    spec_w, hit, peak, phit, ppeak = spec_state
    qq = _qq(queries)
    live0 = ~state.done
    zeros_k = torch.zeros((K,), dtype=torch.int32, device=queries.device)

    def round_fn(st, sw):
        return _sim_round(st, consts, queries, qq, sw, params, geom,
                          part.exchange, part.lo)

    def cond(c):
        st, j = c[0], c[8]
        active, fin = part.any(~st.done, st.done & live0)
        return (j < budget) & active & ~(stop & fin)

    def body(c):
        return _chunk_round(c, round_fn, params.search.rounds_cap, dynamic,
                            spec_cfg)

    carry = (state, spec_w, hit, peak, phit, ppeak, state.n_dist,
             state.pages_unique, torch.zeros_like(budget), zeros_k,
             zeros_k.clone())
    state, spec_w, hit, peak, phit, ppeak, _, _, steps, lc, ws = \
        _predicated(carry, cond, body, K)
    state, spec_state = part.gather((state, (spec_w, hit, peak, phit,
                                             ppeak)))
    return state, spec_state, steps, part.total(lc), part.total(ws)


def engine_run_chunk(consts, state: EngineState, queries, spec_state,
                     spec_cfg, budget, stop_on_finish,
                     params: EngineParams, geom: EngineGeom, K: int,
                     dynamic: bool = False, capture: bool = True,
                     mesh=None):
    """Run up to ``K`` engine rounds in one call, with the per-round
    semantics of K :func:`engine_round` calls and the host controller in
    between: rows reaching ``rounds_cap`` park at the exact boundary the
    per-round scheduler would retire them; with ``dynamic`` the widths
    step through :func:`spec_update` after every round (``spec_state``
    is the controller's ``(spec_w, hit, peak, page_hit, page_peak)``,
    ``spec_cfg`` its parameters).

    The loop condition is the reference's ``(j < budget) &
    (~done).any() & ~(stop_on_finish & (done & live0).any())``: the
    chunk ends after ``budget`` (<= K) rounds, when every live row has
    finished, or — with ``stop_on_finish`` — as soon as any row live at
    entry finishes (the host sets it while unadmitted queries wait, so a
    freed slot is refilled on exactly the round the per-round scheduler
    would refill it). This is the host-paced-admission chunk: the
    frozen-mode path and the ``injit_admit=False`` baseline.

    K predicated rounds, captured once per key on a card; ``budget`` and
    ``stop_on_finish`` may be host values or device scalars. Returns
    ``(state, spec_state', steps, live_cnt (K,), width_sum (K,))``
    without reading the device: ``steps`` (a 0-d device tensor) rounds
    ran; the traces hold the live rows and the summed widths over live
    rows per round (entries past ``steps`` are 0). The outputs are the
    capture cache's buffers, overwritten by the next call of the same
    program.

    On an engine ``mesh`` (launch/mesh.py) every rank calls it with the
    same global tensors and its own shards' ``consts``
    (:func:`shard_consts`): the program runs this rank's rows, its
    exchanges are all-to-alls and its exit tests all-reduced, and the
    outputs come back global (the traces summed over the ranks).
    """
    dev = queries.device
    part = _Part(state.done.shape[0], mesh)
    spec_state = (_widths(spec_state[0], queries.shape[:2], dev),
                  *spec_state[1:])
    budget = _scalar(budget, torch.int32, dev).clamp(max=K)
    stop = _scalar(stop_on_finish, torch.bool, dev)
    key = (params, geom, K, dynamic, tuple(spec_cfg),
           _consts_key(part.check(consts)), *part.key())
    part.warm(dev)

    def chunk(*a):
        n = len(EngineState._fields)
        return _run_chunk(consts, EngineState(*a[:n]), a[n], a[n + 1:n + 6],
                          a[n + 6], a[n + 7], spec_cfg, params, geom, K,
                          dynamic, part)

    return cap.CACHE.run("engine_run_chunk", chunk, key,
                         (*state, queries, *spec_state, budget, stop), K,
                         capture)


def _seat_pending(free, cursor, avail, pend_q, queries_rows, offset=0):
    """Seat arrived pending queries into free rows, in the host staging
    order (rows in order, pending entries in arrival order): the free
    row of exclusive free-rank r < ``avail`` takes pending entry
    ``cursor + r`` (a mesh rank's ranks start at ``offset``, the free
    rows of the lower ranks). One queue: ``free`` (R,) is the flattened pool,
    ``cursor``/``avail`` 0-d, ``pend_q`` (N, d). Per-shard queues (routed
    serving): ``free`` (S, Qs), ``cursor``/``avail`` (S,), ``pend_q``
    (S, N, d); each shard seats its own queue from rank 0, with no
    coupling of free ranks across shards. Returns (seat mask, seated
    pending indices with -1 elsewhere, updated query rows)."""
    rank = torch.cumsum(free.int(), -1) - 1 + offset
    seat = free & (rank < avail[..., None])
    pidx = torch.where(seat, cursor[..., None] + rank, -1)
    safe = pidx.clamp(0, pend_q.shape[-2] - 1)
    picked = torch.take_along_dim(pend_q, safe[..., None], dim=-2)
    new_q = torch.where(seat[..., None], picked, queries_rows)
    return seat, pidx.int(), new_q


def _pending_avail(pend_arr, cursor, tnow):
    """Pending entries whose arrival round has passed and that the
    cursor has not consumed (``pend_arr`` is sorted by arrival, so the
    arrived count is a binary search), per queue: ``pend_arr`` (N,) or
    per-shard (S, N) with cursors of the leading shape; ``tnow`` is a 0-d
    int32 device tensor."""
    t = tnow.reshape(1).expand(pend_arr.shape[:-1] + (1,)).contiguous()
    arrived = torch.searchsorted(pend_arr, t, right=True)[..., 0]
    return (arrived - cursor).clamp_min(0)


def _run_chunk_admit(consts, state: EngineState, queries, spec_state,
                     budget, cursor, t0, pend_q, pend_arr, entry, spec_cfg,
                     params: EngineParams, geom: EngineGeom, K: int,
                     dynamic: bool, part: _Part):
    """The program of :func:`engine_run_chunk_admit` (device tensors
    only): on a mesh, this rank's rows (and, per-shard, its queues),
    gathered at the end."""
    per_shard = pend_arr.dim() == 2
    state, queries, spec_state = part.local((state, queries, spec_state))
    entry = part.local_entry(entry)
    if per_shard:
        pend_q, pend_arr, cursor = part.local((pend_q, pend_arr, cursor))
    k = params.search.k
    S, Qs = state.done.shape
    dev = queries.device
    spec_max = int(spec_cfg[0])
    faults = params.faults
    stalls = faults is not None and faults.any_stall
    zeros_k = torch.zeros((K,), dtype=torch.int32, device=dev)
    zeros_sq = torch.zeros((K, S, Qs), dtype=torch.int32, device=dev)

    def put(trace, at, val):
        return trace.index_copy(0, at, val[None])

    # evicted rows' results are captured before admission; with a live
    # index (delta_cap > 0) the capture masks tombstones and merges the
    # delta, so a mid-chunk eviction honours deletes exactly as a
    # host-side retire does. delta_cap == 0 keeps the frozen finalize.
    if params.delta_cap > 0:
        live = [consts[name] for name in LIVE_CONST_KEYS]

        def capture_fin(st, q):
            return _finalize_live(st, q, *live, k)[:2]
    else:
        def capture_fin(st, q):
            return _finalize(st, k)[:2]

    def cond(c):
        st, cur, j = c[0], c[7], c[8]
        avail = _pending_avail(pend_arr, cur, t0 + j)
        active, arrived = part.any(~st.done, avail > 0)
        return (j < budget) & (active | arrived)

    def body(c):
        (st, q, sw, hi, pk, phi, ppk, cur, j, lc, ws, aq, ri, rd, rr, rn,
         ra, rt) = c
        at = j.clamp(max=K - 1).long().reshape(1)
        avail = _pending_avail(pend_arr, cur, t0 + j)
        # boundary j (global round t0 + j): record the would-be-evicted
        # rows' results, then seat arrived pending queries
        fin_i, fin_d = capture_fin(st, q)
        ri, rd = put(ri, at, fin_i), put(rd, at, fin_d)
        rr, rn = put(rr, at, st.rounds), put(rn, at, st.n_dist)
        ra, rt = put(ra, at, st.age), put(rt, at, st.truncated)
        if per_shard:
            seat, pidx, new_q = _seat_pending(st.done, cur, avail, pend_q,
                                              q)
            cur_next = cur + seat.sum(-1)
        elif part.mesh is None:
            seat, pidx, new_q = _seat_pending(st.done.reshape(-1), cur,
                                              avail, pend_q,
                                              q.reshape(S * Qs, -1))
            cur_next = cur + seat.sum(-1)
        else:
            # the global row-major seating: this rank's free ranks follow
            # the lower ranks' free rows, and the replicated cursor moves
            # by the global seat count, min(free rows, arrived)
            free = st.done.reshape(-1)
            below, total = part.free_below(free)
            seat, pidx, new_q = _seat_pending(free, cur, avail, pend_q,
                                              q.reshape(S * Qs, -1), below)
            cur_next = cur + torch.minimum(total, avail)
        mask = seat.reshape(S, Qs)
        st, q = _admit_rows(st, q, mask, new_q.reshape(S, Qs, -1), *entry,
                            params)
        cur = cur_next
        aq = put(aq, at, pidx.reshape(S, Qs))
        if dynamic:   # fresh rows restart the controller at full width
            sw = torch.where(mask, spec_max, sw)
            hi = torch.where(mask, -1.0, hi)
            pk = torch.where(mask, 0.0, pk)
            phi = torch.where(mask, -1.0, phi)
            ppk = torch.where(mask, 0.0, ppk)
        # the round itself; prev_nd is the post-admission n_dist, so a
        # seated row's first accepted-count delta starts from 0 exactly
        # like a host-admitted fresh row's
        qq = _qq(q)
        st, sw, hi, pk, phi, ppk, _, _, j, lc, ws = _chunk_round(
            (st, sw, hi, pk, phi, ppk, st.n_dist, st.pages_unique, j, lc,
             ws),
            lambda s, w: _sim_round(s, consts, q, qq, w, params, geom,
                                    part.exchange, part.lo),
            params.search.rounds_cap, dynamic, spec_cfg,
            stall=part.local(ftinject.stall_at(faults, t0 + j))[:, None]
            if stalls else None)
        return (st, q, sw, hi, pk, phi, ppk, cur, j, lc, ws, aq, ri, rd,
                rr, rn, ra, rt)

    carry = (state, queries, *spec_state, cursor, torch.zeros_like(t0),
             zeros_k, zeros_k.clone(),
             torch.full((K, S, Qs), -1, dtype=torch.int32, device=dev),
             torch.full((K, S, Qs, k), INVALID, dtype=torch.int32,
                        device=dev),
             torch.zeros((K, S, Qs, k), dtype=torch.float32, device=dev),
             zeros_sq, zeros_sq.clone(), zeros_sq.clone(),
             torch.zeros((K, S, Qs), dtype=torch.bool, device=dev))
    (st, q, sw, hi, pk, phi, ppk, cur, steps, lc, ws, aq, ri, rd, rr, rn,
     ra, rt) = _predicated(carry, cond, body, K)
    st, q, spec_state = part.gather((st, q, (sw, hi, pk, phi, ppk)))
    traces = part.gather((aq, ri, rd, rr, rn, ra, rt), dim=1)
    if per_shard:
        cur = part.gather(cur)
    return (st, q, spec_state, steps, part.total(lc), part.total(ws),
            *traces, cur)


def engine_run_chunk_admit(consts, state: EngineState, queries, spec_state,
                           spec_cfg, budget, pend_q, pend_arr, cursor, t0,
                           entry_vec, entry_norm, entry_id,
                           params: EngineParams, geom: EngineGeom, K: int,
                           dynamic: bool = False, capture: bool = True,
                           mesh=None):
    """:func:`engine_run_chunk` with an admission stage: the pending
    queue lives on the device (``pend_q`` (N, d) vectors and ``pend_arr``
    (N,) int32 arrival rounds, sorted by arrival; ``cursor`` the first
    unadmitted entry, ``t0`` the global round at chunk entry), and every
    round boundary seats arrived entries into free (``done``) rows
    before stepping, so the chunk runs straight through finishes and
    arrivals.

    Per boundary, exactly the per-round host scheduler's semantics: the
    seating order is the host staging order (:func:`_seat_pending`); a
    seated row is reset by :func:`_admit_rows`, the math
    :func:`engine_admit` runs, and (``dynamic``) its controller row
    restarts at full width. A seated row evicts a finished one, so each
    boundary j records admit traces — the pending index seated per slot
    (``admit_qidx[j]``, -1 elsewhere) and every row's pre-admission
    finalize, rounds, n_dist, age and truncated flag (``ret_*[j]``) —
    from which the host replays the accounting bit-exactly.

    The loop condition is the reference's ``(j < budget) &
    ((~done).any() | avail > 0)``: the chunk ends early only when no row
    is live and no pending entry has arrived. K predicated rounds,
    captured once per key on a card (the pending queue and the consts
    are read in place: their addresses are part of the key); ``budget``,
    ``cursor`` and ``t0`` may be host values or device scalars. With a
    fault plan on ``params`` (ft/inject.py), shard kill and delay windows
    are evaluated against the global round ``t0 + j`` (a device scalar)
    at every boundary: a stalled shard's rows do no phase work that round
    but keep aging, so the deadline retires them. This is the only chunk
    driver that knows the global round, which is why stall faults need
    in-device admission.

    Routed serving stages per-shard queues (``pend_q`` (S, N, d),
    ``pend_arr`` (S, N) padded with INT32_MAX, ``cursor`` (S,)): each
    shard seats its own queue from offset 0 (``admit_qidx`` holds indices
    into its shard's queue), the exit test is taken in lockstep over all
    of them, and per-shard entries seed the seated rows. Returns
    ``(state, queries', spec_state', steps, live_cnt, width_sum,
    admit_qidx, ret_i, ret_d, ret_rounds, ret_ndist, ret_age, ret_trunc,
    cursor')`` without reading the device; the traces lead with K,
    ``steps`` is a 0-d device tensor and ``cursor'`` has the cursor's
    shape, and all are the capture cache's buffers.

    On an engine ``mesh`` as :func:`engine_run_chunk`: the flat queue is
    replicated, and each rank seats its rows of the global row-major
    seating (its free ranks offset by the lower ranks' free rows, an
    all-gather per boundary, the reference's); per-shard queues, cursors
    and entries are sliced to this rank's shards. Stall windows are read
    at this rank's rows.
    """
    dev = queries.device
    S, Qs = state.done.shape
    part = _Part(S, mesh)
    if params.faults is not None and params.faults.any_stall and \
            params.faults.num_shards != S:
        raise ValueError(f"fault plan covers {params.faults.num_shards} "
                         f"shards but the pool has {S}")
    spec_state = (_widths(spec_state[0], (S, Qs), dev), *spec_state[1:])
    budget = _scalar(budget, torch.int32, dev).clamp(max=K)
    if pend_arr.dim() == 2:           # per-shard cursors
        cursor = (cursor.to(dev, torch.int64)
                  if isinstance(cursor, torch.Tensor)
                  else to_device(np.asarray(cursor, np.int64), dev))
    else:
        cursor = _scalar(cursor, torch.int64, dev)
    t0 = _scalar(t0, torch.int32, dev)
    entry = (entry_vec, entry_norm, entry_id)
    key = (params, geom, K, dynamic, tuple(spec_cfg),
           _consts_key(part.check(consts)),
           cap.tensor_ptrs(pend_q, pend_arr, *(
               x for x in entry if isinstance(x, torch.Tensor))),
           None if isinstance(entry_id, torch.Tensor) else int(entry_id),
           *part.key())
    part.warm(dev)

    def chunk(*a):
        n = len(EngineState._fields)
        return _run_chunk_admit(
            consts, EngineState(*a[:n]), a[n], a[n + 1:n + 6], a[n + 6],
            a[n + 7], a[n + 8], pend_q, pend_arr, entry, spec_cfg, params,
            geom, K, dynamic, part)

    return cap.CACHE.run("engine_run_chunk_admit", chunk, key,
                         (*state, queries, *spec_state, budget, cursor, t0),
                         K, capture)


def make_stepper(params: EngineParams, geom: EngineGeom, mesh=None,
                 round_chunk: int = 1, routed: bool = False,
                 capture: bool = True) -> EngineStepper:
    """Bundle the stepper stages, for the single-device sim driver or,
    with an engine ``mesh`` (launch/mesh.py), for one rank of it.
    ``round_chunk`` is the K of the chunk stages: the most rounds one
    ``run_chunk`` call runs before the host is consulted. ``capture``
    (default on) runs the chunks as captured graphs on a card.
    ``routed=True`` (the two-tier layout, core/router.py) needs nothing
    more: the stages take per-shard pending queues, cursors and entries
    by their shapes, as the reference's sim leg does.

    On a mesh the stages take and return the sim stepper's global
    ``(S, Qs, ...)`` tensors on every rank, so the host scheduler runs
    unchanged and identically on each: ``init``, ``admit``, ``retire``
    and ``round`` run this rank's rows and all-gather them; the chunks
    are :func:`engine_run_chunk` and :func:`engine_run_chunk_admit` on
    the mesh. ``consts`` are this rank's (:func:`shard_consts`)."""
    K = max(1, int(round_chunk))
    if mesh is not None:
        _mesh_refusals(params)
    part = _Part(geom.num_shards, mesh)

    def init(consts, queries, evec, enorm, eid):
        return part.gather(engine_init(consts, part.local(queries),
                                       *part.local_entry((evec, enorm, eid)),
                                       params, geom))

    def rnd(consts, state, queries, spec_w):
        st, q = part.local((state, queries))
        sw = part.local(_widths(spec_w, queries.shape[:2], queries.device))
        return part.gather(_sim_round(st, part.check(consts), q, _qq(q), sw,
                                      params, geom, part.exchange, part.lo))

    def admit(state, queries, admit_mask, new_q, evec, enorm, eid):
        return part.gather(engine_admit(
            *part.local((state, queries, admit_mask, new_q)),
            *part.local_entry((evec, enorm, eid)), params, geom))

    def retire(state):
        return part.gather(engine_retire(part.local(state), params.search.k))

    def run_chunk(consts, state, queries, spec_state, spec_cfg, budget,
                  stop_on_finish, dynamic=False):
        return engine_run_chunk(consts, state, queries, spec_state,
                                spec_cfg, budget, stop_on_finish, params,
                                geom, K, dynamic, capture, mesh)

    def run_chunk_admit(consts, state, queries, spec_state, spec_cfg,
                        budget, pend, cursor, t0, entry, dynamic=False):
        return engine_run_chunk_admit(
            consts, state, queries, spec_state, spec_cfg, budget, *pend,
            cursor, t0, *entry, params, geom, K, dynamic, capture, mesh)

    return EngineStepper(init, rnd, admit, retire, run_chunk, K,
                         run_chunk_admit)
