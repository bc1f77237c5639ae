"""Graph construction + exact search ground truth (host-side numpy).

The port's own copy of the reference package's ``core/graph.py``
builders: the same arithmetic in the same order, so one seed rebuilds
bit-identical graphs in both packages.

  * exact_knn        — blocked brute-force kNN (float64-accurate, memory-bounded)
  * robust_prune     — Vamana/DiskANN alpha-pruning of a candidate set
  * build_vamana     — DiskANN-style graph: exact kNN candidates + alpha prune
                       + reverse edges + medoid connectivity patch-up
  * brute_force_topk — exact ground truth for recall@k.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

INVALID = -1


def pairwise_sq_dists(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(n,d),(m,d) -> (n,m) squared L2, computed stably in float64."""
    a64 = a.astype(np.float64)
    b64 = b.astype(np.float64)
    an = (a64 * a64).sum(-1)[:, None]
    bn = (b64 * b64).sum(-1)[None, :]
    d = an + bn - 2.0 * (a64 @ b64.T)
    return np.maximum(d, 0.0)


def brute_force_topk(db: np.ndarray, queries: np.ndarray, k: int,
                     block: int = 4096) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k (ids, sq-dists) per query, blocked over the database."""
    nq = queries.shape[0]
    best_d = np.full((nq, k), np.inf)
    best_i = np.full((nq, k), INVALID, dtype=np.int64)
    for s in range(0, db.shape[0], block):
        d = pairwise_sq_dists(queries, db[s: s + block])
        ids = np.arange(s, s + d.shape[1])[None, :].repeat(nq, 0)
        alld = np.concatenate([best_d, d], axis=1)
        alli = np.concatenate([best_i, ids], axis=1)
        sel = np.argsort(alld, axis=1, kind="stable")[:, :k]
        best_d = np.take_along_axis(alld, sel, 1)
        best_i = np.take_along_axis(alli, sel, 1)
    return best_i, best_d


def exact_knn(vectors: np.ndarray, k: int, block: int = 2048) -> np.ndarray:
    """(N,k) nearest neighbors (excluding self), blocked brute force."""
    n = vectors.shape[0]
    out = np.empty((n, k), dtype=np.int32)
    for s in range(0, n, block):
        q = vectors[s: s + block]
        d = pairwise_sq_dists(q, vectors)
        rows = np.arange(s, min(s + block, n))
        d[np.arange(len(rows)), rows] = np.inf  # mask self
        idx = np.argpartition(d, k, axis=1)[:, :k]
        dd = np.take_along_axis(d, idx, 1)
        srt = np.argsort(dd, axis=1, kind="stable")
        out[s: s + block] = np.take_along_axis(idx, srt, 1).astype(np.int32)
    return out


def robust_prune(v: int, candidates: np.ndarray, vectors: np.ndarray,
                 r: int, alpha: float) -> np.ndarray:
    """Vamana RobustPrune: keep diverse candidates (alpha-dominance)."""
    cand = np.unique(candidates[candidates != INVALID])
    cand = cand[cand != v]
    if cand.size == 0:
        return cand.astype(np.int32)
    dv = pairwise_sq_dists(vectors[v][None, :], vectors[cand])[0]
    orderc = np.argsort(dv, kind="stable")
    cand, dv = cand[orderc], dv[orderc]
    kept: list[int] = []
    alive = np.ones(cand.size, dtype=bool)
    for i in range(cand.size):
        if not alive[i]:
            continue
        p = int(cand[i])
        kept.append(p)
        if len(kept) >= r:
            break
        # kill every c with alpha * d(p, c) <= d(v, c)
        rest = np.where(alive)[0]
        rest = rest[rest > i]
        if rest.size:
            dpc = pairwise_sq_dists(vectors[p][None, :], vectors[cand[rest]])[0]
            alive[rest] &= (alpha * alpha) * dpc > dv[rest]
    return np.asarray(kept, dtype=np.int32)


def _greedy_visited(vectors, adjacency, entry: int, query, L: int):
    """GreedySearch visited set (construction helper, numpy)."""
    q = query.astype(np.float64)
    d0 = float(((vectors[entry].astype(np.float64) - q) ** 2).sum())
    cand = [(d0, entry, False)]
    visited = {entry}
    order = [entry]
    while True:
        unexp = [(d, i, j) for j, (d, i, e) in enumerate(cand) if not e]
        if not unexp:
            break
        d, v, j = min(unexp)
        cand[j] = (d, v, True)
        nbrs = [int(u) for u in adjacency[v]
                if u != INVALID and int(u) not in visited]
        if nbrs:
            dn = ((vectors[nbrs].astype(np.float64) - q) ** 2).sum(axis=1)
            for u, du in zip(nbrs, dn):
                visited.add(u)
                order.append(u)
                cand.append((float(du), u, False))
            cand = sorted(cand)[:L]
    return np.asarray(order, dtype=np.int32)


def build_vamana(vectors: np.ndarray, r: int = 32, alpha: float = 1.2,
                 knn_k: Optional[int] = None, seed: int = 0,
                 refine: bool = True,
                 refine_L: int = 0) -> tuple[np.ndarray, int]:
    """DiskANN-style graph. Returns (adjacency (N,r) INVALID-padded, medoid).

    Construction = exact-kNN candidates + alpha-prune + reverse edges
    (first pass), then the Vamana refinement pass (``refine=True``):
    re-insert every vertex using the GreedySearch visited set from the
    medoid as its candidate pool — this is what creates the navigable
    long-range edges a pure kNN graph lacks (recall saturates without
    it on clustered data), exactly DiskANN Algorithm 2."""
    n = vectors.shape[0]
    knn_k = knn_k or min(max(2 * r, r + 8), n - 1)
    knn = exact_knn(vectors, knn_k)
    adjacency = np.full((n, r), INVALID, dtype=np.int32)
    rng = np.random.default_rng(seed)
    for v in range(n):
        cand = knn[v]
        kept = robust_prune(v, cand, vectors, r, alpha)
        adjacency[v, : kept.size] = kept
    # reverse edges (bound degree with prune)
    extra: list[list[int]] = [[] for _ in range(n)]
    for v in range(n):
        for u in adjacency[v]:
            if u != INVALID:
                extra[int(u)].append(v)
    for v in range(n):
        if not extra[v]:
            continue
        cur = adjacency[v][adjacency[v] != INVALID]
        cand = np.concatenate([cur, np.asarray(extra[v], dtype=np.int32)])
        if np.unique(cand).size > r:
            kept = robust_prune(v, cand, vectors, r, alpha)
        else:
            kept = np.unique(cand).astype(np.int32)
        adjacency[v] = INVALID
        adjacency[v, : kept.size] = kept[:r]
    medoid = medoid_of(vectors)

    if refine:
        L_ins = refine_L or max(r + 16, 32)
        for v in rng.permutation(n):
            visited = _greedy_visited(vectors, adjacency, int(medoid),
                                      vectors[v], L_ins)
            cur = adjacency[v][adjacency[v] != INVALID]
            cand = np.unique(np.concatenate(
                [visited[visited != v], cur]))
            kept = robust_prune(int(v), cand.astype(np.int32), vectors, r,
                                alpha)
            adjacency[v] = INVALID
            adjacency[v, : kept.size] = kept[:r]
            # reverse edges for the new out-neighbors (with prune on spill)
            for u in kept:
                row = adjacency[u]
                if v in row:
                    continue
                free = np.where(row == INVALID)[0]
                if free.size:
                    row[free[0]] = v
                else:
                    cand_u = np.concatenate(
                        [row, np.asarray([v], dtype=np.int32)])
                    kept_u = robust_prune(int(u), cand_u, vectors, r, alpha)
                    adjacency[u] = INVALID
                    adjacency[u, : kept_u.size] = kept_u[:r]
    # connectivity patch: ensure everyone is reachable-ish from the medoid by
    # linking isolated vertices to it (rare with exact-kNN candidates)
    deg_in = np.zeros(n, dtype=np.int64)
    for v in range(n):
        for u in adjacency[v]:
            if u != INVALID:
                deg_in[int(u)] += 1
    orphans = np.where(deg_in == 0)[0]
    for v in orphans:
        if v == medoid:
            continue
        row = adjacency[medoid]
        free = np.where(row == INVALID)[0]
        if free.size:
            adjacency[medoid, free[0]] = v
        else:
            adjacency[medoid, rng.integers(0, r)] = v
    _patch_reachability(adjacency, vectors, int(medoid))
    return adjacency, int(medoid)


def _reachable_from(adjacency: np.ndarray, root: int) -> np.ndarray:
    n = adjacency.shape[0]
    seen = np.zeros(n, dtype=bool)
    seen[root] = True
    stack = [root]
    while stack:
        v = stack.pop()
        for u in adjacency[v]:
            if u != INVALID and not seen[u]:
                seen[u] = True
                stack.append(int(u))
    return seen


def _patch_reachability(adjacency: np.ndarray, vectors: np.ndarray,
                        medoid: int, max_pairs: int = 2048) -> None:
    """Guarantee every vertex is reachable from the medoid.

    Exact-kNN candidates on strongly clustered data produce no inter-
    cluster edges (alpha-pruning drops them all), leaving the graph
    disconnected — any graph-traversal search then caps at the medoid
    component's recall. Repair: repeatedly connect the closest
    (reached, unreached) vertex pair with a bidirectional edge (replacing
    the farthest neighbor when the row is full). One iteration merges a
    whole component, so the loop runs ~#components times. This mirrors
    what DiskANN's random-init + GreedySearch insertion achieves
    organically on real (non-separable) data."""
    n = vectors.shape[0]
    rng = np.random.default_rng(1234)
    protected = np.zeros(adjacency.shape, dtype=bool)   # patch edges stay
    for _ in range(2 * n):
        seen = _reachable_from(adjacency, medoid)
        if seen.all():
            return
        ru = np.where(seen)[0]
        un = np.where(~seen)[0]
        if ru.size > max_pairs:
            ru = rng.choice(ru, max_pairs, replace=False)
        if un.size > max_pairs:
            un = rng.choice(un, max_pairs, replace=False)
        d = pairwise_sq_dists(vectors[ru], vectors[un])
        i, j = np.unravel_index(int(np.argmin(d)), d.shape)
        u, w = int(ru[i]), int(un[j])
        for a, b in ((u, w), (w, u)):
            row = adjacency[a]
            if b in row:
                continue
            free = np.where(row == INVALID)[0]
            if free.size:
                slot = int(free[0])
            else:
                # evict the farthest UNPROTECTED neighbor (protected patch
                # edges are the spanning structure: evicting them thrashes)
                cand = np.where(~protected[a])[0]
                if cand.size == 0:
                    continue
                nbr_d = pairwise_sq_dists(vectors[a][None],
                                          vectors[row[cand]])[0]
                slot = int(cand[int(np.argmax(nbr_d))])
            row[slot] = b
            protected[a, slot] = True


def medoid_of(vectors: np.ndarray, sample: int = 4096, seed: int = 0) -> int:
    n = vectors.shape[0]
    rng = np.random.default_rng(seed)
    probe = vectors[rng.choice(n, size=min(sample, n), replace=False)]
    center = probe.mean(axis=0, keepdims=True)
    d = pairwise_sq_dists(center, vectors)[0]
    return int(np.argmin(d))


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean fraction of true top-k recovered. found/true: (nq, k)."""
    nq, k = true_ids.shape
    hits = 0
    for q in range(nq):
        hits += len(set(found_ids[q].tolist()) & set(true_ids[q].tolist()))
    return hits / (nq * k)
