"""Static scheduling, level 1 (§VI-A): vertex reordering (host-side numpy).

The port's own copy of the reference package's *degree-ascending
breadth-first traversal reordering*: deterministic (runs once),
near-optimal average vertex bandwidth

    beta(G, f) = (1/n) * sum_v  max_{(i,j) in E(v)} |f(i) - f(j)|

The result is a permutation `order` with new_id = rank[old_id], applied
by `apply_reordering`; `bandwidth_beta` scores an ordering. The paper's
baselines (Fig. 16) are `random_bfs` (random roots and neighbour order,
from a seeded numpy stream: the reference's orders exactly) and
`identity_order`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

INVALID = -1


def _adjacency_sets(adjacency: np.ndarray) -> list[np.ndarray]:
    return [row[row != INVALID] for row in adjacency]


def degree_ascending_bfs(adjacency: np.ndarray,
                         symmetrize: bool = True) -> np.ndarray:
    """Paper's reordering. Returns `order`: order[new_id] = old_id.

    Root = global min-degree vertex; BFS; the frontier expansion of each
    dequeued vertex enqueues its unvisited neighbors in degree-ascending
    order (ties by old id -> fully deterministic). Disconnected components
    are processed in min-degree order.
    """
    n, _ = adjacency.shape
    adj = _adjacency_sets(adjacency)
    if symmetrize:
        # treat edges as undirected for ordering purposes
        rev: list[list[int]] = [[] for _ in range(n)]
        for v in range(n):
            for u in adj[v]:
                rev[int(u)].append(v)
        adj = [np.unique(np.concatenate([adj[v], np.asarray(rev[v], np.int32)]))
               if rev[v] else adj[v] for v in range(n)]
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    # component roots by (degree, id)
    root_order = np.lexsort((np.arange(n), deg))
    root_ptr = 0
    from collections import deque
    queue: deque[int] = deque()
    while pos < n:
        while root_ptr < n and visited[root_order[root_ptr]]:
            root_ptr += 1
        root = int(root_order[root_ptr])
        visited[root] = True
        queue.append(root)
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            nbrs = adj[v]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs) == 0:
                continue
            # degree-ascending, ties by id (deterministic)
            k = np.lexsort((nbrs, deg[nbrs]))
            for u in nbrs[k]:
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    return order


def random_bfs(adjacency: np.ndarray, seed: int = 0) -> np.ndarray:
    """Random-root, random-neighbour-order BFS (the 'ran bfs' baseline)."""
    n, _ = adjacency.shape
    rng = np.random.default_rng(seed)
    adj = _adjacency_sets(adjacency)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    from collections import deque
    queue: deque[int] = deque()
    roots = rng.permutation(n)
    root_ptr = 0
    while pos < n:
        while visited[roots[root_ptr]]:
            root_ptr += 1
        root = int(roots[root_ptr])
        visited[root] = True
        queue.append(root)
        while queue:
            v = queue.popleft()
            order[pos] = v
            pos += 1
            nbrs = adj[v]
            nbrs = nbrs[~visited[nbrs]]
            if len(nbrs) == 0:
                continue
            for u in rng.permutation(nbrs):
                if not visited[u]:
                    visited[u] = True
                    queue.append(int(u))
    return order


def identity_order(n: int) -> np.ndarray:
    return np.arange(n, dtype=np.int64)


def apply_reordering(vectors: np.ndarray, adjacency: np.ndarray,
                     order: np.ndarray, entry: int
                     ) -> tuple[np.ndarray, np.ndarray, int]:
    """Relabel the graph: new vertex i holds old vertex order[i].

    Returns (vectors', adjacency', entry') in the new id space.
    """
    n = vectors.shape[0]
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.arange(n, dtype=np.int64)
    new_vectors = vectors[order]
    remapped = np.where(adjacency != INVALID,
                        rank[np.clip(adjacency, 0, n - 1)], INVALID)
    new_adjacency = remapped[order].astype(np.int32)
    return new_vectors, new_adjacency, int(rank[entry])


def bandwidth_beta(adjacency: np.ndarray,
                   order: Optional[np.ndarray] = None) -> float:
    """Average vertex bandwidth beta(G, f) under the given ordering (Eq. 1)."""
    n, _ = adjacency.shape
    rank = np.empty(n, dtype=np.int64)
    if order is None:
        rank = np.arange(n, dtype=np.int64)
    else:
        rank[order] = np.arange(n, dtype=np.int64)
    valid = adjacency != INVALID
    nbr_rank = np.where(valid, rank[np.clip(adjacency, 0, n - 1)], 0)
    span = np.abs(nbr_rank - rank[:, None])
    span = np.where(valid, span, 0)
    has = valid.any(axis=1)
    per_vertex = span.max(axis=1)
    return float(per_vertex[has].mean()) if has.any() else 0.0
