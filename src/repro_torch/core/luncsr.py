"""LUNCSR — the paper's graph format (§IV-B), host-side numpy.

The port's own copy of the reference package's ``core/luncsr.py``
builders (``Geometry``, ``LUNCSR``, ``PackedIndex``, ``pack_index``), so
one seed packs bit-identical arrays in both packages.

CSR (offsets / neighbors) extended with *physical placement* arrays so a
logical vertex id resolves to its physical location without a translation
table lookup on the critical path:

  paper                         here
  -----                         ----
  LUN array  (which LUN)        shard id, arithmetic striping (+ refresh kept
                                within a shard, mirroring the paper's
                                "refresh within planes" constraint §VI-A3)
  BLK array  (block in LUN)     blk_perm[shard] : logical block -> physical
                                block, updated by core/refresh.py
  page/column from logical id   page-in-block and slot derived from the id

Vertex id -> placement (page_size = P vectors/page, S shards):
  global_page   g = id // P
  shard         s = owner(g)        (striping mode, see below)
  local page    q = local_page(g)   (logical, within shard)
  logical block b = q // pages_per_block ; page_in_block = q % pages_per_block
  physical page   = blk_perm[s, b] * pages_per_block + page_in_block
  slot            = id % P

Striping modes (static-scheduling step 2, the multi-plane mapping analogue):
  "striped"    : consecutive pages round-robin across shards (g % S) --
                 page-level spatial locality *and* cross-shard parallelism
                 (the paper's plane/LUN-interleaved fill, Fig. 13).
  "sequential" : fill a shard completely before the next (the "no multi-plane
                 mapping" ablation baseline of Fig. 16/18).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.utils import cdiv, round_up

INVALID = -1


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Physical geometry of the sharded vector store (the 'SiN' array)."""

    num_shards: int = 1          # LUN-group count (leading shard axis)
    page_size: int = 256         # vectors per page (one kernel page read)
    pages_per_block: int = 8     # refresh granularity
    dim: int = 128               # feature dimension (padded)
    stripe: str = "striped"      # "striped" | "sequential"

    def __post_init__(self):
        assert self.stripe in ("striped", "sequential")

    def num_pages_total(self, n: int) -> int:
        return cdiv(n, self.page_size)

    def pages_per_shard(self, n: int) -> int:
        """Logical pages a shard must hold for n vertices (padded uniform)."""
        gp = self.num_pages_total(n)
        per = cdiv(gp, self.num_shards)
        return round_up(per, self.pages_per_block)

    def blocks_per_shard(self, n: int) -> int:
        return self.pages_per_shard(n) // self.pages_per_block

    def padded_n(self, n: int) -> int:
        return self.pages_per_shard(n) * self.num_shards * self.page_size

    # -- logical placement (arithmetic; the engine repeats it on tensors) --
    def owner_of(self, ids):
        g = ids // self.page_size
        if self.stripe == "striped":
            return g % self.num_shards
        per = None  # sequential needs total pages; callers use owner_of_n
        raise ValueError("sequential striping requires owner_of_n(ids, n)")

    def owner_of_n(self, ids, n: int):
        g = ids // self.page_size
        if self.stripe == "striped":
            return g % self.num_shards
        return g // self.pages_per_shard(n)

    def local_page_of_n(self, ids, n: int):
        """Logical page index within the owner shard."""
        g = ids // self.page_size
        if self.stripe == "striped":
            return g // self.num_shards
        return g % self.pages_per_shard(n)

    def local_slot_of_n(self, ids, n: int):
        """Logical dense slot within shard = local_page * P + slot_in_page."""
        return self.local_page_of_n(ids, n) * self.page_size + ids % self.page_size

    def slot_in_page(self, ids):
        return ids % self.page_size


@dataclasses.dataclass
class LUNCSR:
    """Host-side (numpy) LUNCSR index over a vector dataset.

    offsets   : (N+1,) int64   CSR row offsets
    neighbors : (E,)   int32   CSR adjacency (vertex ids in *current* order)
    vectors   : (N, d) float32 feature vectors, row i = vertex i
    lun       : (N,)   int32   owner shard per vertex (matches geometry striping)
    blk       : (N,)   int32   logical block within shard per vertex
    blk_perm  : (S, B) int32   logical block -> physical block (refresh state)
    pref      : (N, R2) int32  precomputed 2nd-order speculative prefetch lists
                               (the Pref Unit's connectivity-ranked selection)
    entry     : int            entry vertex (medoid) for the search
    """

    geometry: Geometry
    offsets: np.ndarray
    neighbors: np.ndarray
    vectors: np.ndarray
    lun: np.ndarray
    blk: np.ndarray
    blk_perm: np.ndarray
    pref: Optional[np.ndarray] = None
    entry: int = 0

    @property
    def n(self) -> int:
        return int(self.vectors.shape[0])

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])

    def degree(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def neighbor_lists(self, max_degree: int) -> np.ndarray:
        """Dense (N, R) adjacency padded with INVALID."""
        n = self.n
        out = np.full((n, max_degree), INVALID, dtype=np.int32)
        deg = self.degree()
        for i in range(n):
            d = min(int(deg[i]), max_degree)
            out[i, :d] = self.neighbors[self.offsets[i]: self.offsets[i] + d]
        return out

    # ------------------------------------------------------------------
    @staticmethod
    def from_adjacency(
        vectors: np.ndarray,
        adjacency: np.ndarray,           # (N, R) padded with INVALID
        geometry: Geometry,
        entry: int = 0,
        pref_width: int = 0,
    ) -> "LUNCSR":
        """Build LUNCSR from a dense padded adjacency + placement arithmetic."""
        n = vectors.shape[0]
        valid = adjacency != INVALID
        deg = valid.sum(axis=1).astype(np.int64)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=offsets[1:])
        neighbors = adjacency[valid].astype(np.int32)
        ids = np.arange(n, dtype=np.int64)
        lun = geometry.owner_of_n(ids, n).astype(np.int32)
        lpage = geometry.local_page_of_n(ids, n)
        blk = (lpage // geometry.pages_per_block).astype(np.int32)
        blk_perm = np.tile(
            np.arange(geometry.blocks_per_shard(n), dtype=np.int32),
            (geometry.num_shards, 1),
        )
        pref = None
        if pref_width > 0:
            pref = build_prefetch_lists(adjacency, pref_width)
        return LUNCSR(
            geometry=geometry, offsets=offsets, neighbors=neighbors,
            vectors=np.ascontiguousarray(vectors, dtype=np.float32),
            lun=lun, blk=blk, blk_perm=blk_perm, pref=pref, entry=entry,
        )

    def validate(self) -> None:
        n = self.n
        g = self.geometry
        assert self.offsets.shape == (n + 1,)
        assert (self.neighbors >= 0).all() and (self.neighbors < n).all()
        ids = np.arange(n, dtype=np.int64)
        np.testing.assert_array_equal(self.lun, g.owner_of_n(ids, n))
        lpage = g.local_page_of_n(ids, n)
        np.testing.assert_array_equal(self.blk, lpage // g.pages_per_block)
        assert self.blk_perm.shape == (g.num_shards, g.blocks_per_shard(n))
        for s in range(g.num_shards):
            assert sorted(self.blk_perm[s].tolist()) == list(
                range(g.blocks_per_shard(n))
            ), "blk_perm must be a permutation per shard"


def build_prefetch_lists(adjacency: np.ndarray, width: int) -> np.ndarray:
    """Per-vertex 2nd-order prefetch list, ranked by connectivity (§VI-B2).

    The Pref Unit "selects the second-order neighbors that have more
    connections with the first-order neighbors". This depends only on
    topology, so it is precomputed offline (static index build).
    """
    n, r = adjacency.shape
    out = np.full((n, width), INVALID, dtype=np.int32)
    adj_sets = [set(row[row != INVALID].tolist()) for row in adjacency]
    for v in range(n):
        first = adjacency[v][adjacency[v] != INVALID]
        counts: dict[int, int] = {}
        fset = set(first.tolist())
        for u in first:
            for w in adjacency[u]:
                if w == INVALID or w == v or w in fset:
                    continue
                counts[int(w)] = counts.get(int(w), 0) + 1
        ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))[:width]
        for j, (w, _) in enumerate(ranked):
            out[v, j] = w
    return out


# ---------------------------------------------------------------------------
# Packing to device-layout arrays (leading shard axis).
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PackedIndex:
    """Device layout of a LUNCSR index. All arrays lead with the shard axis.

    db        : (S, pages, P, d)  vectors at *physical* page positions
    adj       : (S, n_local, R)   neighbor ids (global, INVALID-padded),
                                  indexed by *logical* local slot
    adj_owner : (S, n_local, R)   owner shard of each neighbor (LUN array view)
    pref      : (S, n_local, R2)  speculative prefetch ids (optional: R2=0)
    pref_owner: (S, n_local, R2)
    blk_perm  : (S, B)            logical block -> physical block
    vnorm     : (S, pages, P)     ||v||^2 at physical positions (for the
                                  distance kernel's  q.q - 2q.v + v.v  form)
    """

    geometry: Geometry
    n: int
    max_degree: int
    db: np.ndarray
    adj: np.ndarray
    adj_owner: np.ndarray
    pref: np.ndarray
    pref_owner: np.ndarray
    blk_perm: np.ndarray
    vnorm: np.ndarray
    entry: int

    @property
    def num_shards(self) -> int:
        return self.geometry.num_shards

    @property
    def pages_per_shard(self) -> int:
        return self.db.shape[1]

    @property
    def n_local(self) -> int:
        return self.adj.shape[1]

    @staticmethod
    def from_arrays(*, db, vnorm, adj, adj_owner, pref, pref_owner,
                    blk_perm, entry: int, n: int, max_degree: int,
                    num_shards: int, page_size: int, pages_per_block: int,
                    dim: int, stripe: str = "striped") -> "PackedIndex":
        """A packed index from plain arrays and geometry ints — the form
        in which an index packed elsewhere (e.g. by the reference
        package) crosses into the port. Arrays are copied as numpy with
        the dtypes :func:`pack_index` produces."""
        geometry = Geometry(num_shards=num_shards, page_size=page_size,
                            pages_per_block=pages_per_block, dim=dim,
                            stripe=stripe)
        i32, f32 = np.int32, np.float32
        return PackedIndex(
            geometry=geometry, n=int(n), max_degree=int(max_degree),
            db=np.array(db, f32), adj=np.array(adj, i32),
            adj_owner=np.array(adj_owner, i32), pref=np.array(pref, i32),
            pref_owner=np.array(pref_owner, i32),
            blk_perm=np.array(blk_perm, i32), vnorm=np.array(vnorm, f32),
            entry=int(entry))


def pack_index(index: LUNCSR, max_degree: int, dim_pad: Optional[int] = None,
               dtype=np.float32) -> PackedIndex:
    """Pack a host LUNCSR into the sharded device layout."""
    g = index.geometry
    n = index.n
    d = index.dim if dim_pad is None else dim_pad
    assert d >= index.dim
    S = g.num_shards
    P = g.page_size
    pages = g.pages_per_shard(n)
    n_local = pages * P

    db = np.zeros((S, pages, P, d), dtype=dtype)
    adj = np.full((S, n_local, max_degree), INVALID, dtype=np.int32)
    r2 = 0 if index.pref is None else index.pref.shape[1]
    pref = np.full((S, n_local, max(r2, 1)), INVALID, dtype=np.int32)

    ids = np.arange(n, dtype=np.int64)
    shard = g.owner_of_n(ids, n)
    lpage = g.local_page_of_n(ids, n)
    blk = lpage // g.pages_per_block
    pib = lpage % g.pages_per_block
    phys_page = index.blk_perm[shard, blk] * g.pages_per_block + pib
    slot = ids % P
    db[shard, phys_page, slot, : index.dim] = index.vectors

    lslot = lpage * P + slot  # logical slot (metadata placement; no refresh)
    dense = index.neighbor_lists(max_degree)
    adj[shard, lslot, :] = dense
    if index.pref is not None:
        pref[shard, lslot, :r2] = index.pref

    def owner_table(idtab):
        own = np.full(idtab.shape, INVALID, dtype=np.int32)
        v = idtab != INVALID
        own[v] = g.owner_of_n(idtab[v].astype(np.int64), n)
        return own

    vnorm = (db.astype(np.float64) ** 2).sum(axis=-1).astype(np.float32)
    return PackedIndex(
        geometry=g, n=n, max_degree=max_degree, db=db,
        adj=adj, adj_owner=owner_table(adj),
        pref=pref, pref_owner=owner_table(pref),
        blk_perm=index.blk_perm.astype(np.int32),
        vnorm=vnorm, entry=index.entry,
    )


def physical_page_of(packed: PackedIndex, ids: np.ndarray):
    """Host-side Allocator arithmetic: logical id -> (shard, phys page, slot)."""
    g = packed.geometry
    n = packed.n
    ids = np.asarray(ids, dtype=np.int64)
    shard = g.owner_of_n(ids, n)
    lpage = g.local_page_of_n(ids, n)
    blk = lpage // g.pages_per_block
    pib = lpage % g.pages_per_block
    phys = packed.blk_perm[shard, blk] * g.pages_per_block + pib
    return shard, phys, ids % g.page_size
