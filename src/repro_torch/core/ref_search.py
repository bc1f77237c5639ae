"""Pure-numpy reference search — the correctness oracle.

The port's own copy of the reference package's ``core/ref_search.py``:
``SearchParams`` and ``lockstep_search``, the exact algorithm the torch
traversal and engine implement (batched W-way best-first expansion,
bloom visited set, (dist, id)-lexicographic candidate merge). With
integer-valued vectors every float32 op is exact, so the torch
implementation must match this oracle *bit for bit* (tested).

Shared semantics (mirrored in core/traversal.py and core/engine.py):
  - candidate list: L slots, ascending (dist, id), INVALID-padded
  - a round expands the best W unexpanded candidates ("W=1" is the paper's
    serial traversal; W>1 is the speculative widening of §VI-B2)
  - visited = bloom filter (2 hashes, utils constants); inserted for every
    proposal whose distance is computed; false positives only skip work
  - within-round duplicate proposals are dropped (first occurrence wins)
  - distances: squared L2 via q.q - 2 q.v + v.v in float32
  - termination: no unexpanded valid candidate remains in the list
"""
from __future__ import annotations

import dataclasses

import numpy as np

INVALID = -1
ID_SENTINEL = np.int32(2**31 - 1)
BIG = np.float32(3.0e38)

_H1 = np.uint32(0x9E3779B1)
_H2 = np.uint32(0x85EBCA77)


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Static search configuration shared by all implementations."""

    L: int = 32            # candidate-list length (beam)
    W: int = 1             # expansions per round (1 = paper-faithful serial)
    k: int = 10            # results returned
    max_rounds: int = 0    # 0 -> 4 * L // W
    bloom_words: int = 64  # visited bloom: words of 32 bits (power of two)

    @property
    def rounds_cap(self) -> int:
        return self.max_rounds if self.max_rounds > 0 else 4 * self.L // max(self.W, 1)

    @property
    def bloom_bits(self) -> int:
        return self.bloom_words * 32


# ---------------------------------------------------------------------------
# numpy bloom (identical constants/arithmetic to utils.bloom_*)
# ---------------------------------------------------------------------------
def np_bloom_hashes(ids: np.ndarray, num_bits: int):
    u = ids.astype(np.uint32)
    with np.errstate(over="ignore"):
        h1 = (u * _H1) >> np.uint32(7)
        h2 = ((u + np.uint32(1)) * _H2) >> np.uint32(5)
    mask = np.uint32(num_bits - 1)
    return (h1 & mask).astype(np.int64), (h2 & mask).astype(np.int64)


def np_bloom_insert(bloom: np.ndarray, ids: np.ndarray) -> None:
    p1, p2 = np_bloom_hashes(ids, bloom.size * 32)
    for p in (p1, p2):
        np.bitwise_or.at(bloom, p // 32, np.uint32(1) << (p % 32).astype(np.uint32))


def np_bloom_query(bloom: np.ndarray, ids: np.ndarray) -> np.ndarray:
    p1, p2 = np_bloom_hashes(ids, bloom.size * 32)
    h1 = (bloom[p1 // 32] >> (p1 % 32).astype(np.uint32)) & np.uint32(1)
    h2 = (bloom[p2 // 32] >> (p2 % 32).astype(np.uint32)) & np.uint32(1)
    return (h1 & h2).astype(bool)


def sq_dist_f32(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """float32  q.q - 2 q.v + v.v  (exact for small-integer-valued inputs)."""
    q = q.astype(np.float32)
    v = v.astype(np.float32)
    qq = np.float32((q * q).sum())
    vv = (v * v).sum(axis=-1, dtype=np.float32)
    qv = v @ q  # float32 accumulate
    return qq - np.float32(2.0) * qv + vv


def _merge(cand_d, cand_i, cand_e, new_d, new_i, L):
    """Lexicographic (dist, id) merge; new entries unexpanded."""
    d = np.concatenate([cand_d, new_d]).astype(np.float32)
    i = np.concatenate([cand_i, new_i]).astype(np.int64)
    e = np.concatenate([cand_e, np.zeros(len(new_d), dtype=bool)])
    order = np.lexsort((i, d))[:L]
    return d[order], i[order], e[order]


def lockstep_search(db: np.ndarray, adj: np.ndarray, query: np.ndarray,
                    entry: int, params: SearchParams,
                    trace: list | None = None):
    """Single-query lockstep search. Returns (ids, dists, rounds, stats).

    ``trace`` (optional list) collects per-round dicts for exact-equality
    testing against the JAX implementation.
    """
    L, W = params.L, params.W
    R = adj.shape[1]
    bloom = np.zeros(params.bloom_words, dtype=np.uint32)

    cand_d = np.full(L, BIG, dtype=np.float32)
    cand_i = np.full(L, ID_SENTINEL, dtype=np.int64)
    cand_e = np.zeros(L, dtype=bool)
    # seed with the entry vertex
    cand_d[0] = sq_dist_f32(query, db[entry][None])[0]
    cand_i[0] = entry
    np_bloom_insert(bloom, np.asarray([entry]))

    rounds = 0
    n_dist = 0
    pages = set()
    while rounds < params.rounds_cap:
        valid_unexp = (~cand_e) & (cand_i != ID_SENTINEL)
        if not valid_unexp.any():
            break
        sel_pos = np.where(valid_unexp)[0][:W]
        cand_e[sel_pos] = True
        prop_ids: list[int] = []
        seen_this_round: set[int] = set()
        for p in sel_pos:
            v = int(cand_i[p])
            for u in adj[v]:
                if u == INVALID:
                    continue
                u = int(u)
                if u in seen_this_round:
                    continue  # in-round dedup, first occurrence wins
                seen_this_round.add(u)
                prop_ids.append(u)
        if prop_ids:
            ids = np.asarray(prop_ids, dtype=np.int64)
            fresh = ~np_bloom_query(bloom, ids)
            ids = ids[fresh]
        else:
            ids = np.empty(0, dtype=np.int64)
        if ids.size:
            d = sq_dist_f32(query, db[ids])
            np_bloom_insert(bloom, ids)
            n_dist += ids.size
            cand_d, cand_i, cand_e = _merge(cand_d, cand_i, cand_e, d, ids, L)
        rounds += 1
        if trace is not None:
            trace.append({
                "round": rounds,
                "cand_i": cand_i.copy(),
                "cand_d": cand_d.copy(),
                "cand_e": cand_e.copy(),
                "proposed": ids.copy(),
            })

    k = params.k
    ok = cand_i != ID_SENTINEL
    out_i = np.where(ok, cand_i, INVALID)[:k]
    out_d = cand_d[:k]
    stats = {"rounds": rounds, "n_dist": n_dist, "pages": pages}
    return out_i, out_d, rounds, stats


def lockstep_search_batch(db, adj, queries, entry, params: SearchParams):
    nq = queries.shape[0]
    ids = np.full((nq, params.k), INVALID, dtype=np.int64)
    dists = np.full((nq, params.k), BIG, dtype=np.float32)
    rounds = np.zeros(nq, dtype=np.int64)
    for q in range(nq):
        i, d, r, _ = lockstep_search(db, adj, queries[q], entry, params)
        ids[q], dists[q], rounds[q] = i, d, r
    return ids, dists, rounds


def classic_beam_search(db: np.ndarray, adj: np.ndarray, query: np.ndarray,
                        entry: int, L: int, k: int):
    """Textbook serial DiskANN GreedySearch with an exact visited set:
    expand the best unexpanded candidate, add its unvisited neighbours,
    keep the best L by (distance, id), until every candidate is
    expanded. Returns (ids (k,) int64, dists (k,) float32)."""
    dist0 = float(sq_dist_f32(query, db[entry][None])[0])
    cand: list = [(dist0, entry, False)]
    visited = {entry}
    while True:
        unexp = [(d, i, j) for j, (d, i, e) in enumerate(cand) if not e]
        if not unexp:
            break
        d, v, j = min(unexp)
        cand[j] = (d, v, True)
        news = []
        for u in adj[v]:
            if u == INVALID or int(u) in visited:
                continue
            visited.add(int(u))
            news.append((float(sq_dist_f32(query, db[int(u)][None])[0]),
                         int(u), False))
        cand = sorted(cand + news)[:L]
    top = sorted(cand)[:k]
    return (np.asarray([i for _, i, _ in top], dtype=np.int64),
            np.asarray([d for d, _, _ in top], dtype=np.float32))
