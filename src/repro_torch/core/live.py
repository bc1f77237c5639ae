"""Live index: streaming inserts, tombstone deletes, epoch swaps.

NDSEARCH freezes graph, LUN-CSR layout and reorder permutation at build
time; this module breaks that assumption the way a production vector DB
must: a bounded write-optimised **delta segment** absorbs inserts, a
**tombstone bitset** absorbs deletes, and a background **reindex**
(core/refresh.py:``reindex_epoch``) folds both into a fresh main graph
that swaps in at a round-chunk boundary.

The host side is the reference's (``src/repro/core/live.py``) in numpy,
bit for bit, rng streams included. The device side is fixed-shape by
design, so a session captures its admission chunk once however many
inserts, deletes and swaps it sees:

  * capacity = n0 + scheduled inserts, fixed up front; every epoch packs
    at capacity (pad seats are unreachable), so db/vnorm/adj/pref/
    blk_perm never change shape;
  * the delta arrays (delta_vec/delta_norm/delta_live) and the tombstone
    bitset are (delta_cap, ...) / (capacity,) arrays whose *contents*
    change; ``EngineParams.delta_cap`` is the only static knob;
  * external ids name vectors across epochs: epoch 0's internal ids ARE
    the external ids, inserts take ``n0, n0+1, ...``, so a zero-churn
    session emits exactly what the frozen path does.

The scheduler (core/scheduler.py) drives this object at round-chunk
boundaries: ``advance(t)`` applies due mutations (possibly triggering a
swap), ``take_translation()`` maps the previous epoch's internal ids
into the new one so in-flight queries keep their frontiers, and
``map_result()`` rewrites retired rows to external ids while masking
anything that died since the row was scored. The scheduler owns the
device tensors and writes each epoch's contents into them in place.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import MAIN_CONST_KEYS
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import (EpochIndex, Geometry, pack_padded,
                                     physical_page_of)
from repro_torch.core.refresh import reindex_epoch
from repro_torch.core.reorder import apply_reordering, degree_ascending_bfs

INVALID = -1
_BIG = np.float32(3.4e38)


@dataclasses.dataclass(frozen=True)
class MutationSchedule:
    """Pre-generated insert/delete arrivals (Poisson, like query arrivals).

    t      : (M,) int64 round of each mutation, ascending
    is_ins : (M,) bool  insert (True) vs delete (False)
    vec    : (M, d) f32 payload for inserts (zero rows for deletes)
    """

    t: np.ndarray
    is_ins: np.ndarray
    vec: np.ndarray

    @property
    def num_inserts(self) -> int:
        return int(self.is_ins.sum())

    def __len__(self) -> int:
        return int(self.t.shape[0])


def mutation_schedule(insert_rate: float, delete_rate: float, horizon: int,
                      dim: int, seed: int = 0,
                      ref: Optional[np.ndarray] = None) -> MutationSchedule:
    """Poisson insert/delete arrivals over ``horizon`` rounds.

    Insert payloads are drawn near randomly chosen reference vectors
    when ``ref`` is given (new points land inside the data distribution,
    so recall against them is meaningful), else standard normal.
    """
    rng = np.random.default_rng(seed)
    n_ins = int(rng.poisson(max(insert_rate, 0.0) * horizon))
    n_del = int(rng.poisson(max(delete_rate, 0.0) * horizon))
    t = np.sort(rng.integers(0, max(horizon, 1), size=n_ins + n_del))
    is_ins = np.zeros(n_ins + n_del, dtype=bool)
    is_ins[rng.permutation(n_ins + n_del)[:n_ins]] = True
    vec = np.zeros((n_ins + n_del, dim), dtype=np.float32)
    if n_ins:
        if ref is not None and len(ref):
            base = ref[rng.integers(0, len(ref), size=n_ins)]
            vec[is_ins] = (base + 0.1 * rng.standard_normal(
                (n_ins, dim))).astype(np.float32)
        else:
            vec[is_ins] = rng.standard_normal((n_ins, dim)).astype(np.float32)
    return MutationSchedule(t=t.astype(np.int64), is_ins=is_ins, vec=vec)


class LiveIndex:
    """Epoch-versioned index manager: delta inserts, tombstone deletes,
    background reindex with a swap. Host-side; the engine only ever sees
    fixed-shape consts."""

    def __init__(self, ep: EpochIndex, *, seed: int = 0,
                 refresh_every: int = 0,
                 schedule: Optional[MutationSchedule] = None,
                 pref_width: int = 0, router=None, router_seed: int = 0):
        self.ep = ep
        self.seed = int(seed)
        self.refresh_every = int(refresh_every)
        self.schedule = schedule
        self.pref_width = int(pref_width)
        self.router = router
        self.router_seed = int(router_seed)
        self._cursor = 0
        self._since_refresh = 0
        live_ext = ep.ext_ids[ep.ext_ids >= 0]
        self.next_ext = int(live_ext.max()) + 1 if live_ext.size else 0
        self.where: dict[int, tuple[str, int]] = {}
        self._index_main()
        self.inserts = 0
        self.deletes = 0
        self.swaps = 0
        self.delta_hits = 0
        self.reindex_s = 0.0     # host seconds spent in refresh()
        self._rng = np.random.default_rng(seed + 17)  # delete-target draw
        self._ext_prev: Optional[np.ndarray] = None

    def _index_main(self) -> None:
        self.where = {int(e): ("m", i)
                      for i, e in enumerate(self.ep.ext_ids) if e >= 0}

    # -- shape contract ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.ep.capacity

    @property
    def delta_cap(self) -> int:
        return self.ep.delta_cap

    def live_consts(self, device) -> dict:
        return self.ep.live_consts(device)

    def main_consts(self, device, *, host_pages: bool = False) -> dict:
        """The current epoch's main graph as tensors on ``device`` (the
        keys and shapes of ``pack_for_engine``'s consts); ``host_pages``
        keeps ``db`` / ``vnorm`` in host memory, as the cold tier of a
        tiered session."""
        p = self.ep.packed
        return {k: torch.as_tensor(
            getattr(p, k),
            device="cpu" if host_pages and k in ("db", "vnorm") else device)
            for k in MAIN_CONST_KEYS}

    def device_entry(self, device):
        """(entry_vec (d,), entry_norm 0-d, entry_id 0-d int32) of the
        current epoch, on ``device``."""
        p = self.ep.packed
        s, pg, sl = (int(x[0]) for x in physical_page_of(p, [p.entry]))
        return (torch.tensor(p.db[s, pg, sl], dtype=torch.float32,
                             device=device),
                torch.tensor(p.vnorm[s, pg, sl], dtype=torch.float32,
                             device=device),
                torch.tensor(p.entry, dtype=torch.int32, device=device))

    # -- mutations --------------------------------------------------------
    def insert(self, vec: np.ndarray) -> int:
        """Append to the delta; returns the new external id. A full delta
        forces a refresh first (the bounded-delta invariant)."""
        if self.ep.delta_len >= self.delta_cap:
            self.refresh()
        if self.ep.n_live() >= self.capacity:
            raise ValueError(
                f"live set at capacity {self.capacity}; size the session "
                "capacity to n0 + total scheduled inserts")
        ep = self.ep
        row = ep.delta_len
        v = np.asarray(vec, dtype=np.float32).reshape(-1)
        ep.delta_vec[row] = v
        ep.delta_norm[row] = np.float32(
            (v.astype(np.float64) ** 2).sum())  # same accumulate as pack
        ep.delta_live[row] = True
        ext = self.next_ext
        ep.delta_ext[row] = ext
        ep.delta_len = row + 1
        self.where[ext] = ("d", row)
        self.next_ext += 1
        self.inserts += 1
        self._note_mutation()
        return ext

    def delete(self, ext: int) -> bool:
        """Tombstone (main) or kill (delta) an external id."""
        loc = self.where.pop(int(ext), None)
        if loc is None:
            return False
        kind, i = loc
        if kind == "m":
            self.ep.tombs[i] = True
        else:
            self.ep.delta_live[i] = False
        self.deletes += 1
        self._note_mutation()
        return True

    def _note_mutation(self) -> None:
        self._since_refresh += 1
        if self.refresh_every and self._since_refresh >= self.refresh_every:
            self.refresh()

    def refresh(self) -> None:
        """Fold delta + tombstones into a new epoch (the swap unit).

        Snapshots the outgoing epoch's ext map once per swap window so
        ``take_translation`` can bridge in-flight queries even across
        several swaps inside one scheduler boundary."""
        t0 = time.perf_counter()
        if self._ext_prev is None:
            self._ext_prev = self.ep.ext_ids.copy()
        self.ep = reindex_epoch(
            self.ep, seed=self.seed + 101 * (self.ep.epoch + 1),
            pref_width=self.pref_width)
        self._index_main()
        self.swaps += 1
        self._since_refresh = 0
        if self.router is not None:
            from repro_torch.core.router import refresh_router
            self.router = refresh_router(
                self.router, self.ep,
                seed=self.router_seed + 1000 * self.ep.epoch)
        self.reindex_s += time.perf_counter() - t0

    # -- scheduler surface -------------------------------------------------
    def due(self, t: int) -> bool:
        s = self.schedule
        return (s is not None and self._cursor < len(s)
                and int(s.t[self._cursor]) <= t)

    def advance(self, t: int) -> tuple[bool, int]:
        """Apply all scheduled mutations due by round ``t``. Returns
        (any mutation applied, number of epoch swaps triggered)."""
        changed = False
        swaps0 = self.swaps
        s = self.schedule
        while self.due(t):
            i = self._cursor
            self._cursor += 1
            if s.is_ins[i]:
                self.insert(s.vec[i])
            else:
                exts = sorted(self.where)  # deterministic target draw
                if exts:
                    self.delete(int(exts[int(self._rng.integers(
                        0, len(exts)))]))
            changed = True
        return changed, self.swaps - swaps0

    def take_translation(self) -> Optional[np.ndarray]:
        """(prev capacity,) old-internal -> new-internal id map across the
        swap window opened by the first :meth:`refresh` since the last
        call; -1 for ids with no surviving seat. Clears the snapshot."""
        if self._ext_prev is None:
            return None
        ext_prev = self._ext_prev
        self._ext_prev = None
        inv = {int(e): i for i, e in enumerate(self.ep.ext_ids) if e >= 0}
        trans = np.full(ext_prev.shape[0], -1, dtype=np.int64)
        for i, e in enumerate(ext_prev):
            if e >= 0:
                trans[i] = inv.get(int(e), -1)
        return trans

    def map_result(self, ids: np.ndarray, dists: np.ndarray):
        """Rewrite one retired row to external ids; stable-partition any
        entry that is dead *now* (tombstoned, killed delta row, pad seat)
        to the back as (INVALID, BIG_DIST). With zero churn this is the
        identity (the ext map is the identity and nothing is dead)."""
        ids = np.asarray(ids)
        dists = np.asarray(dists)
        ep = self.ep
        cap = ep.capacity
        dcap = ep.delta_cap
        main = (ids >= 0) & (ids < cap)
        delt = ids >= cap
        self.delta_hits += int(delt.sum())
        mi = np.clip(ids, 0, cap - 1)
        di = np.clip(ids - cap, 0, dcap - 1)
        ext = np.where(main, ep.ext_ids[mi], np.int64(INVALID))
        ext = np.where(delt, ep.delta_ext[di], ext)
        alive = ((main & ~ep.tombs[mi]) | (delt & ep.delta_live[di]))
        alive &= ext >= 0
        dead = (ids >= 0) & ~alive
        out_i = np.where(ids < 0, ids.astype(np.int64), ext)
        out_d = dists.copy()
        if dead.any():
            order = np.argsort(dead, kind="stable")
            out_i = out_i[order]
            out_d = out_d[order]
            dd = dead[order]
            out_i[dd] = INVALID
            out_d[dd] = _BIG
        return out_i.astype(ids.dtype), out_d

    def final_dataset(self):
        """(vectors, ext ids) of the current live set: the ground-truth
        basis after a mutation workload."""
        ep = self.ep
        m = (ep.ext_ids >= 0) & ~ep.tombs
        vecs = np.concatenate([ep.vectors[m], ep.delta_vec[ep.delta_live]])
        exts = np.concatenate([ep.ext_ids[m], ep.delta_ext[ep.delta_live]])
        return vecs, exts


def live_index_from_graph(vecs: np.ndarray, adj: np.ndarray, entry: int, *,
                          shards: int, page_size: int, r: int,
                          delta_cap: int, capacity: int,
                          pref_width: int = 0, seed: int = 0,
                          refresh_every: int = 0,
                          schedule: Optional[MutationSchedule] = None,
                          router=None, router_seed: int = 0) -> LiveIndex:
    """Epoch 0 over an already built and reordered graph (``vecs`` and
    ``adj`` in vertex order, ``entry`` its medoid), packed at
    ``capacity``, wrapped in a :class:`LiveIndex` with the identity
    external-id map: the tail of :func:`build_live_index`, for a caller
    that holds the frozen build's graph."""
    n0, d = vecs.shape
    geom = Geometry(num_shards=shards, page_size=page_size,
                    pages_per_block=4, dim=d, stripe="striped")
    packed = pack_padded(vecs, adj, geom, entry, r, capacity=capacity,
                         pref_width=pref_width)
    vmirror = np.zeros((capacity, d), dtype=np.float32)
    vmirror[:n0] = vecs
    emirror = np.full(capacity, -1, dtype=np.int64)
    emirror[:n0] = np.arange(n0)  # epoch-0 internal ids ARE the ext ids
    ep = EpochIndex.empty(packed, vmirror, emirror, delta_cap=delta_cap)
    return LiveIndex(ep, seed=seed, refresh_every=refresh_every,
                     schedule=schedule, pref_width=pref_width,
                     router=router, router_seed=router_seed)


def build_live_index(db: np.ndarray, *, shards: int, page_size: int, r: int,
                     delta_cap: int, capacity: Optional[int] = None,
                     pref_width: int = 0, seed: int = 0,
                     refresh_every: int = 0,
                     schedule: Optional[MutationSchedule] = None,
                     router=None, router_seed: int = 0) -> LiveIndex:
    """Build epoch 0 over ``db`` and wrap it in a :class:`LiveIndex`.

    Mirrors ``launch.search.build_index`` (Vamana -> degree-ascending
    BFS -> pack) but packs at ``capacity`` (default: ``n0`` plus the
    schedule's insert count) and records the identity external-id map;
    with ``capacity == n0`` the packed arrays are exactly the frozen
    build's.
    """
    if capacity is None:
        capacity = db.shape[0] + (schedule.num_inserts
                                  if schedule is not None else 0)
    adj, medoid = build_vamana(db, r=r, seed=seed)
    order = degree_ascending_bfs(adj)
    vecs, adj, entry = apply_reordering(db, adj, order, entry=medoid)
    return live_index_from_graph(
        vecs, adj, entry, shards=shards, page_size=page_size, r=r,
        delta_cap=delta_cap, capacity=capacity, pref_width=pref_width,
        seed=seed, refresh_every=refresh_every, schedule=schedule,
        router=router, router_seed=router_seed)
