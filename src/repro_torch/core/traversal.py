"""Single-shard batched best-first traversal.

The torch form of ``core.ref_search.lockstep_search``: identical round
semantics, batched over queries. The distributed engine (core/engine.py)
reuses the per-query primitives exported here: ``select_expand``,
``dedup_in_round``, ``merge_candidates``. Each takes any number of
leading batch axes (the engine passes (shards, queries)).

Hot paths (distance + merge) dispatch through a
:class:`repro_torch.core.backend.KernelBackend`: the inline ``torch``
mode is gather + dot and a lexicographic sort, while ``ref``/``cuda``/
``auto`` route the same math through the paged SiN distance and bitonic
merge kernels — bit-identical on integer-valued vectors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.backend import KernelBackend, paged_view
from repro_torch.core.ref_search import SearchParams
from repro_torch.utils import (BIG_DIST, ID_SENTINEL, INVALID, bloom_insert,
                               bloom_query, resolve_device)

_TORCH = KernelBackend(mode="torch")


class TraversalState(NamedTuple):
    cand_d: torch.Tensor      # (Q, L) f32 ascending
    cand_i: torch.Tensor      # (Q, L) i32, ID_SENTINEL-padded
    cand_e: torch.Tensor      # (Q, L) bool, expanded flags
    bloom: torch.Tensor       # (Q, bloom_bits) bool visited bloom
    done: torch.Tensor        # (Q,) bool
    rounds: torch.Tensor      # (Q,) i32 rounds in which this query did work
    n_dist: torch.Tensor      # (Q,) i32 distance computations
    page_acc: torch.Tensor    # (Q,) i32 unique-page touches summed over rounds


# ---------------------------------------------------------------------------
# Shared per-query primitives (also used by core/engine.py)
# ---------------------------------------------------------------------------
def sort_by_dist_id(d, i, *others, backend: KernelBackend | None = None):
    """Ascending lexicographic (dist, id) sort along the last axis.

    ``others`` ride along as payload lanes. Inline mode sorts by id, then
    stably by dist; kernel modes run the bitonic network on
    power-of-two padded rows.
    """
    backend = backend or _TORCH
    lead, m = d.shape[:-1], d.shape[-1]
    flat = backend.sort_pairs(d.reshape(-1, m), i.reshape(-1, m),
                              *(o.reshape(-1, m) for o in others))
    return tuple(x.reshape(lead + (m,)) for x in flat)


def select_expand(cand_d, cand_i, cand_e, W: int):
    """Pick the best W valid unexpanded candidates per query.

    Returns (sel_ids (..., W) i32, sel_valid (..., W) bool, cand_e' with
    the selected positions marked expanded).
    """
    L = cand_i.shape[-1]
    ar = torch.arange(L, device=cand_i.device)
    valid_unexp = (~cand_e) & (cand_i != ID_SENTINEL)
    pos = torch.where(valid_unexp, ar, L)
    pos = torch.sort(pos, dim=-1).values[..., :W]               # (..., W)
    sel_valid = pos < L
    sel_ids = cand_i.gather(-1, pos.clamp(max=L - 1))
    sel_ids = torch.where(sel_valid, sel_ids, ID_SENTINEL)
    cand_e = cand_e | (pos[..., :, None] == ar).any(dim=-2)
    return sel_ids, sel_valid, cand_e


def dedup_in_round(ids, valid):
    """Drop duplicate proposals within a round (first occurrence wins).

    ids/valid: (..., M). Returns updated valid.
    """
    eq = ids[..., :, None] == ids[..., None, :]
    eq &= valid[..., :, None] & valid[..., None, :]
    m = ids.shape[-1]
    earlier = torch.ones((m, m), dtype=torch.bool,
                         device=ids.device).tril(diagonal=-1)
    return valid & ~(eq & earlier).any(dim=-1)


def merge_candidates(cand_d, cand_i, cand_e, new_d, new_i, new_valid, L: int,
                     backend: KernelBackend | None = None):
    """Merge proposals into the candidate list; keep best L by (dist, id).

    The candidate list is always sorted, so kernel modes sort only the M
    fresh proposals and run a single bitonic *merge* pass against the
    sorted list. The ``expanded`` flags travel through as a payload lane
    (zeros on the proposal side)."""
    backend = backend or _TORCH
    new_d = torch.where(new_valid, new_d, BIG_DIST)
    new_i = torch.where(new_valid, new_i, ID_SENTINEL)
    new_e = torch.zeros_like(new_valid)
    lead = cand_d.shape[:-1]
    lc, m = cand_d.shape[-1], new_d.shape[-1]
    d, i, e = backend.merge_unsorted(
        cand_d.reshape(-1, lc), cand_i.reshape(-1, lc),
        new_d.reshape(-1, m), new_i.reshape(-1, m),
        pay_a=(cand_e.reshape(-1, lc),), pay_b=(new_e.reshape(-1, m),))
    return tuple(x.reshape(lead + (lc + m,))[..., :L] for x in (d, i, e))


def count_unique_pages(ids, valid, page_size: int):
    """#unique pages among valid ids, per query. ids: (..., M)."""
    pages = torch.where(valid, ids // page_size, ID_SENTINEL)
    pages = torch.sort(pages, dim=-1).values
    first = torch.ones_like(valid)
    first[..., 1:] = pages[..., 1:] != pages[..., :-1]
    return (first & (pages != ID_SENTINEL)).sum(-1).to(torch.int32)


def squared_dists(queries, qq, vecs, vnorm,
                  backend: KernelBackend | None = None):
    """q.q - 2 q.v + v.v ; queries (Q,d), vecs (Q,M,d), vnorm (Q,M).

    Kernel modes treat each query's gathered candidate set as one "page"
    ((Q, M, d) is a (NP=Q, P=M, d) paged store) and run the SiN distance
    kernel over it; inline mode is one batched product."""
    backend = backend or _TORCH
    if backend.inline:
        qv = torch.einsum("qd,qmd->qm", queries, vecs)
        return (qq[:, None] - 2.0 * qv) + vnorm
    Q = queries.shape[0]
    out = backend.paged_distance(
        torch.arange(Q, dtype=torch.int32, device=queries.device),
        queries[:, None, :], qq[:, None], vecs, vnorm)       # (Q, 1, M)
    return out[:, 0, :]


# ---------------------------------------------------------------------------
# Single-shard search
# ---------------------------------------------------------------------------
def init_state(db, vnorm, queries, entry: int,
               params: SearchParams) -> TraversalState:
    Q, L = queries.shape[0], params.L
    dev = queries.device
    qq = (queries * queries).sum(-1)
    e_ids = torch.full((Q, 1), entry, dtype=torch.int32, device=dev)
    e_d = squared_dists(queries, qq, db[e_ids.long()], vnorm[e_ids.long()])
    cand_d = torch.cat([e_d, torch.full((Q, L - 1), BIG_DIST, device=dev)], 1)
    cand_i = torch.cat([e_ids, torch.full((Q, L - 1), ID_SENTINEL,
                                          dtype=torch.int32, device=dev)], 1)
    cand_e = torch.zeros((Q, L), dtype=torch.bool, device=dev)
    bloom = torch.zeros((Q, params.bloom_bits), dtype=torch.bool, device=dev)
    bloom = bloom_insert(bloom, e_ids, torch.ones_like(cand_e[:, :1]))
    zeros = torch.zeros((Q,), dtype=torch.int32, device=dev)
    return TraversalState(cand_d, cand_i, cand_e, bloom, zeros.bool(),
                          zeros, zeros, zeros)


def search(db, adj, vnorm, queries, entry: int, params: SearchParams,
           page_size: int = 256, kernel_mode: str = "torch",
           coalesce_qb: int = 8, device="cuda"):
    """Batched best-first search on a single shard.

    db (N,d) f32 | adj (N,R) i32 INVALID-padded | vnorm (N,) f32 | queries
    (Q,d) f32, as numpy arrays or tensors; they are moved to ``device``.
    Returns (ids (Q,k) i32, dists (Q,k) f32, stats dict).

    ``kernel_mode`` selects the backend for the distance + merge hot
    paths: the inline ``torch`` path, or the SiN/bitonic kernels
    (``ref``/``cuda``/``auto``) on the page-granular view of ``db`` —
    identical results on integer vectors. ``coalesce_qb`` sets the
    per-page query-tile width in kernel modes (0 = one page read per
    assignment). The round loop runs on the host and checks the done
    mask once per round.
    """
    dev = resolve_device(device)
    db, adj, vnorm, queries = (torch.as_tensor(x, device=dev)
                               for x in (db, adj, vnorm, queries))
    backend = KernelBackend(mode=kernel_mode, coalesce_qb=coalesce_qb)
    Q = queries.shape[0]
    L, W, R = params.L, params.W, adj.shape[1]
    n = db.shape[0]
    qq = (queries * queries).sum(-1)
    if not backend.inline:
        db_pg, vnorm_pg = paged_view(db, vnorm, page_size)
    qidx = torch.arange(Q, device=dev).repeat_interleave(W * R)

    def round_fn(state: TraversalState) -> TraversalState:
        sel_ids, sel_valid, cand_e = select_expand(
            state.cand_d, state.cand_i, state.cand_e, W)
        active = ~state.done
        sel_valid &= active[:, None]
        nbrs = adj[sel_ids.long().clamp(0, n - 1)].reshape(Q, W * R)
        valid = (nbrs != INVALID) & sel_valid.repeat_interleave(R, dim=1)
        valid = dedup_in_round(nbrs, valid)
        valid &= ~bloom_query(state.bloom, nbrs)
        # the SiN kernel point: inline gather + dot, or page reads on the
        # paged view of db (page-sorted, coalesced into query tiles)
        safe = nbrs.long().clamp(0, n - 1)
        if backend.inline:
            dists = squared_dists(queries, qq, db[safe], vnorm[safe])
        else:
            flat = safe.reshape(-1)
            dists = backend.item_distances(
                flat // page_size, flat % page_size, valid.reshape(-1),
                queries[qidx], qq[qidx], db_pg, vnorm_pg).reshape(nbrs.shape)
        dists = torch.where(valid, dists, BIG_DIST)
        bloom = bloom_insert(state.bloom, nbrs, valid)
        cand_d, cand_i, cand_e = merge_candidates(
            state.cand_d, state.cand_i, cand_e, dists, nbrs, valid, L,
            backend=backend)
        # freeze finished queries
        keep = state.done[:, None]
        cand_d = torch.where(keep, state.cand_d, cand_d)
        cand_i = torch.where(keep, state.cand_i, cand_i)
        cand_e = torch.where(keep, state.cand_e, cand_e)
        bloom = torch.where(keep, state.bloom, bloom)
        rounds = state.rounds + active.int()
        n_dist = state.n_dist + torch.where(active, valid.sum(-1), 0).int()
        page_acc = state.page_acc + torch.where(
            active, count_unique_pages(nbrs, valid, page_size), 0).int()
        done = state.done | ~((~cand_e) & (cand_i != ID_SENTINEL)).any(-1)
        return TraversalState(cand_d, cand_i, cand_e, bloom, done,
                              rounds, n_dist, page_acc)

    state = init_state(db, vnorm, queries, entry, params)
    t = 0
    while t < params.rounds_cap and bool((~state.done).any()):
        state = round_fn(state)
        t += 1

    k = params.k
    out_i = torch.where(state.cand_i[:, :k] != ID_SENTINEL,
                        state.cand_i[:, :k], INVALID)
    stats = {"rounds": state.rounds, "n_dist": state.n_dist,
             "page_accesses": state.page_acc, "total_rounds": t}
    return out_i, state.cand_d[:, :k], stats
