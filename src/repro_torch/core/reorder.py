"""Static scheduling, level 1 (§VI-A): vertex reordering (host-side numpy).

The port's own copy of the reference package's *degree-ascending
breadth-first traversal reordering*: deterministic (runs once),
near-optimal average vertex bandwidth

    beta(G, f) = (1/n) * sum_v  max_{(i,j) in E(v)} |f(i) - f(j)|

The result is a permutation `order` with new_id = rank[old_id], applied
by `apply_reordering`.
"""
from __future__ import annotations

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
