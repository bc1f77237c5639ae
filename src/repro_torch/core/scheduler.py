"""Streaming query scheduler on top of the engine's round-stepper API.

NDSEARCH keeps the SEARSSD pipeline saturated by scheduling at the
*query* level, not the batch level (§V): finished queries leave the
pipeline immediately and fresh ones take their place, and the
speculative-search width adapts to the observed hit rate instead of
being fixed up front. The frozen-batch driver (``search_sim``) does
neither — finished queries occupy rows in every remaining round, and
``spec_width`` is a static knob.

This module closes the gap with three pieces over the stepper
(``engine_init / engine_run_chunk[_admit] / engine_admit /
engine_retire``):

  * **slot pool + continuous admission** — a fixed (S, Qs) pool of query
    slots. Rows whose query finished are *retired* (results emitted with
    per-query latency) and refilled from a pending queue (slot
    compaction by replacement): while the queue is non-empty every row
    of every round is a live query, never padding.
  * **dynamic speculation** — a :class:`SpecController` watches the
    per-round deltas of each row's ``n_dist`` counter and moves its
    speculation width between 0 and ``params.spec_width``: wide while
    the frontier is fresh, narrow as acceptance collapses near
    convergence. The rule (:func:`repro_torch.core.engine.spec_update`)
    keeps stepping per round inside a chunk.
  * **open-loop arrivals** — queries carry arrival *rounds* (the
    serving clock is engine rounds); a query is admitted once its
    arrival round has passed and a slot is free, and its wait + service
    latency is recorded.

**Host-sync model.** One dispatch of ``engine_run_chunk_admit`` runs up
to ``round_chunk`` rounds; the pending queue is staged on the device
(vectors and arrival rounds sorted by arrival, a device cursor) and
every round boundary seats arrived queries into freed slots with the
same math and staging order the host would use. As the reference's
device loop does, a chunk runs on the device without consulting the
host: it is K predicated rounds, captured once per session as a CUDA
graph (in :meth:`StreamScheduler._warmup`) and replayed. The host
blocks once per chunk, at its boundary, where everything the accounting
needs (the rounds run, per-round traces, admit/evict traces, the pool's
counters and results, the controller state) moves to the host in one
transfer. ``StreamStats.host_syncs`` counts those reads: one per
dispatch, what the reference's ``host_dispatches`` counts. Host arrays
go to the device through pinned memory without a wait.

The schedule is *exactly* the per-round schedule: a seated row evicts a
finished one whose results were captured in per-boundary admit traces,
and the host replays them at the chunk boundary to reconstruct
``owner``/``admit_t``/``retire_round``; per-round live-count/width
traces reconstruct the occupancy and speculation traces.

What stays on the host: **result emission** at chunk boundaries, the
**frozen-mode all-free gate** (``refill=False`` admits only into an
all-free pool), **idle-clock jumps** (an empty pool with no arrived
query skips to the next arrival without a dispatch; the skipped rounds
count as ``idle_rounds``) and **wall stamps** (a query admitted
mid-chunk is stamped with the chunk's launch time: wall latency is
chunk-granular).

``injit_admit=False`` uses host-paced admission: the chunk budget is
capped at the next arrival and ``stop_on_finish`` ends a chunk on the
first freed slot while queries wait. Per-query results are
**bit-identical** to the one-shot driver under lossless capacities:
each row's math depends only on its own state, so neither its pool
neighbours nor its admission round change its trajectory.

Fault plans (``params.faults``, ft/inject.py) are checked up front, as
the reference checks them: a kill needs a deadline, stalls need the
in-device admission chunk (the only one that knows the global round),
and the plan must cover the pool's shards. The guard's quarantine count
is reported in ``StreamStats.quarantined``.

**Routed admission** (``routed=True``, ``run(target_shards=...)``):
each query row may only sit in its target shard's slot rows, and each
shard drains its own arrival-ordered queue, host-paced or staged on the
device as per-shard queues with per-shard cursors; a shard with no
routed work stays parked. :func:`routed_stream_search` builds the
two-tier search on it (core/router.py): one *leg* per (query, routed
shard), confined to that shard's subgraph, fused at retire time, with
degraded fusion over known-down shards.

**Admission ring** (``ring_capacity`` > 0, flat in-device path): the
device pending queue is a window of at most that many staged queries,
copied into the same device buffers at every chunk boundary, so device
memory stays flat however long the stream is and the chunk's capture is
reused. When the window is full, ``overload="block"`` keeps arrivals
waiting on the host and ``"shed"`` rejects every arrival that finds it
full (``StreamStats.shed``).

**Tiered page store** (``pagestore=``, core/pagestore.py; flat pool,
both admission paths): the consts' pages are the store's device frame
buffers and translation table, a query whose round reads a
non-resident page stalls for that round, and at every chunk boundary
the page bitmaps ride the chunk's one host read into
``PageStore.boundary`` (commit the staged prefetch, demand-fetch the
misses, stage the next prefetch), which rewrites the frames and the
table in place, so the chunk's capture is reused. A row whose round
counter stays frozen for ``_LIVELOCK_BOUNDARIES`` boundaries (the cache
cannot hold one round's working set) raises.

**Live index** (``live=``, core/live.py; flat or routed at topr >= S,
tiered or not, both admission paths): at every chunk boundary where
mutations are due, the live index applies them on the host and the
session writes the tombstone bitset and the delta segment into its own
device tensors in place; a triggered reindex swaps in a new epoch the
same way (main consts, entry, the tiered store's cold tier and frames),
in-flight candidate lists are translated into the new epoch's ids and
rows whose whole frontier died restart. Retirement masks tombstones
and merges the delta (``_finalize_live``), and results carry external
ids. Every device tensor keeps its address, so a session captures its
chunk once however many swaps it sees.

**Multi-device** (``mesh=``, an engine mesh from launch/mesh.py; flat
or routed, both admission paths): each rank passes its own shards'
consts (:func:`repro_torch.core.engine.shard_consts`, sliced once);
the stepper runs its rows against them and hands back global tensors,
so every rank runs this host loop identically on replicated state and
returns the same records. The tiered page store and the live index
refuse a mesh, as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.dispatch import compute_ranks, scatter_to_buckets
from repro_torch.core.engine import (LIVE_CONST_KEYS, EngineGeom,
                                     EngineParams, _finalize, _Part,
                                     engine_retire_live, make_stepper,
                                     spec_update)
from repro_torch.core.metrics import slot_occupancy
from repro_torch.ft.inject import NEVER
from repro_torch.utils import (BIG_DIST, ID_SENTINEL, INVALID, HostStaging,
                               bloom_insert, resolve_device, to_device,
                               to_host)


# tiered store: consecutive no-round-progress chunk boundaries for one
# live row before the scheduler declares a livelock (the round's page
# working set cannot fit the device cache, so demand fetches thrash
# forever). A legitimate page stall clears at the next boundary.
_LIVELOCK_BOUNDARIES = 256


@dataclasses.dataclass
class SpecController:
    """Per-query hit-rate-driven speculation widths (the paper's dynamic
    speculative search, §V-B).

    Each slot row keeps its own width. Per round the rule sees each
    query's accepted-proposal count (the delta of the engine's per-query
    ``n_dist``) and derives its acceptance rate

        hit_q = accepted_q / (W * (max_degree + spec_w_used_q))

    — the fraction of the adjacency (+ speculation) entries served that
    survived dedup and the bloom filter. **Ordering contract:** the rule
    must see the widths *used* in that round: ``update`` reads
    ``self.spec_w`` before overwriting it, and the in-chunk path passes
    the used widths explicitly. Each query's smoothed hit is compared
    with its own running peak, and the width follows the normalized
    rate linearly between ``floor`` (width 0) and ``ceil`` (full
    ``spec_max``).

    The math lives in :func:`repro_torch.core.engine.spec_update`; this
    class is the host-side mirror that carries ``(spec_w, hit, peak,
    page_hit, page_peak)`` across chunk boundaries and resets rows at
    admission, so the per-round and in-chunk controllers are
    bit-identical.
    """

    spec_max: int
    W: int
    max_degree: int
    floor: float = 0.2      # normalized hit at/below which spec_w -> 0
    ceil: float = 0.6       # normalized hit at/above which spec_w -> max
    ema: float = 0.5        # smoothing of the per-round hit estimate
    page_w: float = 0.0     # weight of the page-efficiency signal
                            # (accepted / fresh unique pages, normalized
                            # against its own peak like the hit rate);
                            # 0 keeps the pure hit-rate rule
    spec_w: np.ndarray = dataclasses.field(default=None, repr=False)
    _hit: np.ndarray = dataclasses.field(default=None, repr=False)
    _peak: np.ndarray = dataclasses.field(default=None, repr=False)
    _phit: np.ndarray = dataclasses.field(default=None, repr=False)
    _ppeak: np.ndarray = dataclasses.field(default=None, repr=False)

    @property
    def cfg(self):
        """The static rule parameters, as f32/i32 scalars."""
        return (np.int32(self.spec_max), np.int32(self.W),
                np.int32(self.max_degree), np.float32(self.floor),
                np.float32(self.ceil), np.float32(self.ema),
                np.float32(self.page_w))

    def _ensure(self, shape):
        if self.spec_w is None or self.spec_w.shape != shape:
            self.spec_w = np.full(shape, self.spec_max, np.int32)
            self._hit = np.full(shape, -1.0, np.float32)
            self._peak = np.zeros(shape, np.float32)
            self._phit = np.full(shape, -1.0, np.float32)
            self._ppeak = np.zeros(shape, np.float32)

    def reset_rows(self, mask: np.ndarray):
        """Fresh queries restart at full width (called at admission)."""
        self._ensure(mask.shape)
        self.spec_w[mask] = self.spec_max
        self._hit[mask] = -1.0
        self._peak[mask] = 0.0
        self._phit[mask] = -1.0
        self._ppeak[mask] = 0.0

    def state(self, device="cpu"):
        """The controller state as tensors on ``device`` (copies to a
        card are queued without a wait)."""
        return tuple(to_device(x, device) for x in (
            self.spec_w, self._hit, self._peak, self._phit, self._ppeak))

    def store(self, spec_state):
        """Adopt the post-chunk controller state (tensors or arrays)."""
        if isinstance(spec_state[0], torch.Tensor):
            spec_state = to_host(*spec_state)
        sw, hi, pk, phi, ppk = spec_state
        # private mutable copies: reset_rows writes them in place
        self.spec_w = np.array(sw, np.int32)
        self._hit = np.array(hi, np.float32)
        self._peak = np.array(pk, np.float32)
        self._phit = np.array(phi, np.float32)
        self._ppeak = np.array(ppk, np.float32)

    def update(self, accepted: np.ndarray, worked: np.ndarray,
               pages_delta=None) -> np.ndarray:
        """accepted: (S, Qs) this-round accepted proposals per slot;
        worked: (S, Qs) rows that were live this round; pages_delta:
        this round's fresh unique-page count per shard ((S,), ignored
        at page_w=0). ``self.spec_w`` must still hold the widths used
        in that round (see the class doc)."""
        self._ensure(np.shape(accepted))
        sw, hi, pk, phi, ppk = self.state()
        self.store(spec_update(
            sw, hi, pk, torch.as_tensor(np.asarray(accepted, np.int32)),
            torch.as_tensor(np.asarray(worked, bool)), self.cfg,
            None if pages_delta is None
            else torch.as_tensor(np.asarray(pages_delta, np.int32)),
            phi, ppk))
        return self.spec_w


# cfg placeholder handed to the chunk when no controller is attached
# (dynamic=False never reads it)
_NULL_CFG = (np.int32(0), np.int32(1), np.int32(1),
             np.float32(0.0), np.float32(1.0), np.float32(0.5),
             np.float32(0.0))


@dataclasses.dataclass
class QueryResult:
    """Per-query record emitted at retirement."""

    qid: int
    ids: np.ndarray           # (k,) i32
    dists: np.ndarray         # (k,) f32
    arrival_round: int
    admit_round: int
    retire_round: int
    service_rounds: int       # rounds the query actually worked
    n_dist: int
    wall_latency_s: float     # admit -> retire wall clock
    truncated: bool = False   # retired incomplete: deadline hit, or a
                              # routed leg dropped/deadlined — the ids
                              # are the best-so-far, not a converged
                              # traversal
    legs_fused: int = 0       # routed: legs that finished cleanly and
                              # were fused (0 on the flat path)
    coverage: float = 1.0     # routed: legs_fused / R — the fraction
                              # of the query's routed shards searched
                              # to completion
    stall_rounds: int = 0     # serving-clock rounds aged without working
                              # (a tiered-store page miss, a fault plan's
                              # kill or delay; routed: summed over legs)

    @property
    def wait_rounds(self) -> int:
        return self.admit_round - self.arrival_round

    @property
    def latency_rounds(self) -> int:
        return self.retire_round - self.arrival_round


@dataclasses.dataclass
class StreamStats:
    """Aggregate scheduler run statistics."""

    results: list             # [QueryResult] in retirement order
    total_rounds: int         # engine rounds stepped (busy rounds)
    occupancy: float          # mean live-slots / total-slots over the
                              # full serving clock (busy + idle rounds)
    occupancy_trace: list     # per-busy-round live-slot counts
    pages_unique: int         # cumulative unique page reads
    items_recv: int
    props_sent: int
    drops_b: int
    spec_trace: list          # mean spec_w over live rows, each round
    wall_s: float             # steady-state wall clock (excl. warmup)
    host_dispatches: int = 0  # chunk launches
    host_syncs: int = 0       # device-to-host reads the host blocked on:
                              # the chunk boundary's one transfer per
                              # dispatch (the reference's host blocks)
    compile_s: float = 0.0    # one-time warmup seconds (kernel builds)
    warmup_rounds: int = 0    # engine rounds the warmup chunk ran on a
                              # throwaway pool, off the serving clock
    idle_rounds: int = 0      # serving-clock rounds the pool sat empty
                              # waiting for an arrival (no engine work)
    injit_admit: bool = False  # admission path the run actually used
    legs: int = 0             # routed serving: slot-pool rows served
                              # (N queries x R target shards, less the
                              # legs of down shards); 0 = one row per
                              # query
    items_by_shard: list = dataclasses.field(default_factory=list)
                              # per-shard items_recv — the routed path's
                              # work-skew/idle-shard evidence
    shed: int = 0             # queries rejected by the shed overload
                              # policy (admission ring full at arrival)
    truncated: int = 0        # queries retired incomplete: deadline
                              # force-retire, or routed legs lost to a
                              # down shard / leg deadline
    quarantined: int = 0      # corrupt distances quarantined to
                              # BIG_DIST by the guard (guard_nonfinite)
    legs_fused_hist: list = dataclasses.field(default_factory=list)
                              # routed: legs_fused histogram, index f =
                              # queries whose f legs finished cleanly
                              # (length R+1; empty on the flat path)
    stalls: int = 0           # sum of QueryResult.stall_rounds
    prefetch_hits: int = 0    # tiered store: prefetched pages that
                              # were touched before eviction
    prefetch_issued: int = 0  # tiered store: pages staged by the
                              # speculative prefetcher
    resident_fraction: float = 1.0
                              # tiered store: device frames / logical
                              # pages per shard (1.0 = untiered)
    delta_hits: int = 0       # live index: retired result entries
                              # served from the delta segment
    tombstoned: int = 0       # live index: deletes applied during the
                              # run (main tombstones + killed delta rows)
    epoch_swaps: int = 0      # live index: background reindexes swapped
                              # in during the run
    swap_stall_rounds: int = 0
                              # live index: worked rounds discarded at
                              # swaps (rows whose whole frontier died
                              # restart from the new entry)

    def by_qid(self):
        return {r.qid: r for r in self.results}


class StreamScheduler:
    """Continuous-batching scheduler over a fixed (S, Qs) slot pool on
    ``device`` (where ``consts`` must live; ``pack_for_engine``).

    ``round_chunk`` sets how many engine rounds one dispatch may run
    before the host replays the accounting; any value produces the
    exact per-round schedule. ``injit_admit`` selects the device-side
    pending queue (None = on whenever ``refill`` is; frozen mode keeps
    the host-side all-free gate). ``routed`` allows per-shard
    ``target_shards`` in :meth:`run` (the entry may then be per-shard);
    ``ring_capacity``/``overload`` bound the flat in-device queue (module
    doc). ``capture=False`` runs the chunks eagerly on a card instead of
    as captured graphs (the proof that the two agree). With ``mesh`` (an
    engine mesh, launch/mesh.py) every rank of its group builds the same
    scheduler over its own shards' consts (``shard_consts``) and runs
    the same ``run``: the stepper is the mesh stepper.

    With ``live`` (a :class:`repro_torch.core.live.LiveIndex` whose
    current epoch ``consts`` describe, packed at its capacity, with
    ``params.delta_cap == live.delta_cap``) the scheduler owns copies of
    the main consts (the store's frames stand in for ``db``/``vnorm``
    when tiered), the live index's four consts and the entry, allocated
    once and written in place at every boundary and swap.
    """

    def __init__(self, consts, geom: EngineGeom, params: EngineParams,
                 entry, num_slots: int, mesh=None,
                 controller: Optional[SpecController] = None,
                 refill: bool = True, round_chunk: int = 1,
                 injit_admit: Optional[bool] = None,
                 routed: bool = False, ring_capacity: int = 0,
                 overload: str = "block", pagestore=None, live=None,
                 device="cuda", capture: bool = True):
        if num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {num_slots}")
        if round_chunk < 1:
            raise ValueError(
                f"round_chunk must be >= 1, got {round_chunk}")
        if routed and not refill:
            # per-shard schedules are the point of routing; the frozen
            # all-free gate is a global condition that contradicts it
            raise ValueError("routed serving requires refill=True")
        if overload not in ("shed", "block"):
            raise ValueError(
                f"overload must be 'shed' or 'block', got {overload!r}")
        if ring_capacity < 0:
            raise ValueError(
                f"ring_capacity must be >= 0, got {ring_capacity}")
        self.pagestore = pagestore
        if pagestore is not None:
            # tiered page store: the sim driver's flat pool only (routed
            # legs re-enter the scheduler; tier the flat leg instead)
            if mesh is not None:
                raise ValueError(
                    "the tiered page store runs on the sim driver only "
                    "(mesh must be None)")
            if routed:
                raise ValueError(
                    "routed serving does not support the tiered page "
                    "store")
            if params.store_pages != pagestore.num_pages:
                raise ValueError(
                    f"params.store_pages={params.store_pages} != "
                    f"pagestore.num_pages={pagestore.num_pages}")
            if pagestore.S != geom.num_shards:
                raise ValueError(
                    f"pagestore built for {pagestore.S} shards, "
                    f"geom has {geom.num_shards}")
            # the frame buffers and the translation table stand in for
            # the pages; the store updates them in place at boundaries
            consts = {**consts, **pagestore.device_view()}
        elif params.store_pages > 0:
            raise ValueError(
                "params.store_pages > 0 needs a PageStore (pass "
                "pagestore=...) to own the translation table")
        self.live = live
        if live is not None:
            # the live index: its consts are content updates of a fixed
            # shape, so the chunk's capture outlives every swap. The mesh
            # round has no delta stage, and swaps rewrite host-owned
            # consts: the sim driver only, as in the reference
            if mesh is not None:
                raise ValueError("the live index runs on the sim driver "
                                 "only (mesh must be None)")
            if params.delta_cap <= 0:
                raise ValueError(
                    "a live index needs params.delta_cap > 0 (the static "
                    "gate of the delta-merge retire)")
            if params.delta_cap != live.delta_cap:
                raise ValueError(
                    f"params.delta_cap={params.delta_cap} != "
                    f"live.delta_cap={live.delta_cap}")
            if geom.n != live.capacity:
                raise ValueError(
                    f"geom.n={geom.n} != live capacity {live.capacity} "
                    "(pack at the session capacity)")
        elif params.delta_cap > 0:
            raise ValueError(
                "params.delta_cap > 0 needs a LiveIndex (pass live=...)")
        self.device = resolve_device(device)
        if mesh is not None:
            _Part(geom.num_shards, mesh).check(consts)
        if consts["db"].device.type != self.device.type:
            raise ValueError(
                f"consts live on {consts['db'].device}, the scheduler "
                f"runs on {self.device}: pack_for_engine(packed, device)")
        self.consts = consts
        self.geom = geom
        self.params = params
        self.entry = entry                       # (evec, enorm, eid)
        self.num_slots = num_slots               # per shard
        self.controller = controller
        self.refill = refill
        self.routed = routed
        self.round_chunk = round_chunk
        self.stepper = make_stepper(params, geom, mesh=mesh,
                                    round_chunk=round_chunk, routed=routed,
                                    capture=capture)
        self.injit_admit = refill if injit_admit is None \
            else bool(injit_admit) and refill
        self.S = geom.num_shards
        if ring_capacity > 0:
            if not self.injit_admit:
                raise ValueError(
                    "ring_capacity > 0 bounds the *device* pending queue: "
                    "it needs the in-jit admission path (refill=True, "
                    "injit_admit not disabled)")
            if routed:
                raise ValueError(
                    "ring_capacity applies to the flat pending queue; "
                    "routed serving stages per-shard queues whose device "
                    "footprint is already bounded by the bucket capacity")
        if params.faults is not None:
            f = params.faults
            if f.num_shards != self.S:
                raise ValueError(
                    f"faults.num_shards={f.num_shards} != "
                    f"num_shards={self.S}")
            if f.any_stall and not self.injit_admit:
                raise ValueError(
                    "fault stalls (kill/delay) are evaluated on the "
                    "in-device serving clock: run with in-jit admission "
                    "(refill=True, injit_admit not disabled)")
            if f.any_kill and params.deadline_rounds == 0:
                raise ValueError(
                    "a killed shard never finishes its rows: set "
                    "deadline_rounds > 0 so they force-retire with "
                    "best-so-far results instead of hanging the run")
        self.ring_capacity = int(ring_capacity)
        self.overload = overload
        self._static_spec = None
        # livelock watch of the tiered store (see _tier_boundary)
        self._stall_rounds_prev = None
        self._stall_count = None
        if live is not None:
            self._own_live_tensors()

    # -- the live index's device tensors ------------------------------------
    def _own_live_tensors(self) -> None:
        """Give the session its own copies of every tensor an epoch swap
        rewrites (the main consts the store does not hold, the entry) and
        the live index's four consts: the swaps and boundaries write them
        in place, so their addresses, which key the captured chunk, never
        change, and the caller's tensors are never written."""
        store_keys = () if self.pagestore is None else ("db", "vnorm",
                                                         "ttab")
        self.consts = {k: v if k in store_keys else v.clone()
                       for k, v in self.consts.items()}
        self.consts.update(self.live.live_consts(self.device))
        self.entry = tuple(
            x.clone() if isinstance(x, torch.Tensor)
            else torch.tensor(int(x), dtype=torch.int32, device=self.device)
            for x in self.entry)
        self._live_staging = HostStaging(
            [(self.consts[k].shape, self.consts[k].dtype)
             for k in LIVE_CONST_KEYS], self.device.type == "cuda")

    def _push_live(self) -> None:
        """Write the live index's tombstones and delta segment into the
        session's tensors. ``LiveIndex.insert``/``delete`` rewrite those
        host arrays in place, so the copy reads a pinned snapshot, and the
        next push waits on this copy's event before it rewrites the
        snapshot (the copy itself is queued without a wait)."""
        host = self.live.ep.live_host()
        bufs = self._live_staging.take(1)
        for buf, name in zip(bufs, LIVE_CONST_KEYS):
            buf[0].copy_(torch.from_numpy(host[name]))
            self.consts[name].copy_(buf[0], non_blocking=True)
        self._live_staging.sent(torch.cuda.current_stream(self.device)
                                if self.device.type == "cuda" else None)

    def _retire(self, state, qbuf):
        """Per-slot (ids, dists): the plain finalize, or with a live
        index the live one (tombstones masked, the delta merged; a
        zero-churn session gives the plain one's result)."""
        k = self.params.search.k
        if self.live is None:
            return _finalize(state, k)[:2]
        return engine_retire_live(
            state, qbuf, *(self.consts[name] for name in LIVE_CONST_KEYS),
            k)[:2]

    def _swap_epoch(self, state, qbuf, owner, age_base, rounds_base):
        """Adopt a freshly reindexed epoch mid-session.

        The swap is pure content (every epoch packs at the session
        capacity): the main consts and the entry are written into the
        session's tensors in place (blocking copies from host memory:
        the swap already waited for the host's reindex); with a tiered
        store the cold tier swaps and the resident frames restage
        (``PageStore.swap_epoch``). Nothing is captured again.

        In-flight rows keep serving across the swap: each owned row's
        candidate list is translated old-internal -> new-internal through
        the external ids, dead entries (deleted, or gone in the reindex)
        are compacted out (the list stays sorted: distances are the same
        across epochs), and its bloom filter is rebuilt over the surviving
        list. A row whose whole list died restarts from the new entry:
        its worked rounds are the swap's ``swap_stall_rounds``, and its
        served age carries over through ``age_base``/``rounds_base`` so
        latency accounting stays exact. Returns (state, qbuf, discarded
        rounds)."""
        live = self.live
        mc = live.main_consts("cpu")
        keys = ("adj", "pref", "blk_perm") if self.pagestore is not None \
            else tuple(mc)
        for name in keys:
            dst, src = self.consts[name], mc[name]
            if dst.shape != src.shape or dst.dtype != src.dtype:
                raise ValueError(
                    f"epoch swap changed {name}: {tuple(src.shape)} "
                    f"{src.dtype} != {tuple(dst.shape)} {dst.dtype} (pack "
                    "every epoch at the session capacity)")
            dst.copy_(src)
        if self.pagestore is not None:
            self.pagestore.swap_epoch(mc)
        for dst, src in zip(self.entry, live.device_entry("cpu")):
            dst.copy_(src.expand_as(dst))

        trans = live.take_translation()
        rows = np.argwhere(owner != INVALID)
        if trans is None or rows.size == 0:
            return state, qbuf, 0
        ci, cd, ce, ages, rnds = (np.array(x) for x in to_host(
            state.cand_i, state.cand_d, state.cand_e, state.age,
            state.rounds))
        tmask = np.zeros(owner.shape, bool)
        dead_rows = np.zeros(owner.shape, bool)
        for s, r in rows:
            row_i = ci[s, r]
            valid = row_i != ID_SENTINEL
            t_ids = np.where(
                valid, trans[np.clip(row_i, 0, trans.shape[0] - 1)], -1)
            keep = t_ids >= 0
            m = int(keep.sum())
            if m == 0:
                dead_rows[s, r] = True
                continue
            kd = cd[s, r][keep].copy()
            ke = ce[s, r][keep].copy()
            ci[s, r, :m] = t_ids[keep]
            ci[s, r, m:] = ID_SENTINEL
            cd[s, r, :m] = kd
            cd[s, r, m:] = BIG_DIST
            ce[s, r, :m] = ke
            ce[s, r, m:] = False
            tmask[s, r] = True
        dev = self.device
        if tmask.any():
            w2 = to_device(tmask, dev)
            ci_t = to_device(ci, dev)
            bloom = bloom_insert(torch.zeros_like(state.bloom), ci_t,
                                 (ci_t != ID_SENTINEL) & w2[..., None])
            w3 = w2[..., None]
            state = state._replace(
                cand_i=torch.where(w3, ci_t, state.cand_i),
                cand_d=torch.where(w3, to_device(cd, dev), state.cand_d),
                cand_e=torch.where(w3, to_device(ce, dev), state.cand_e),
                bloom=torch.where(w3, bloom, state.bloom))
        stall = 0
        if dead_rows.any():
            stall = int(rnds[dead_rows].sum())
            age_base[dead_rows] += ages[dead_rows]
            rounds_base[dead_rows] += rnds[dead_rows]
            state, qbuf = self.stepper.admit(
                state, qbuf, to_device(dead_rows, dev), qbuf, *self.entry)
            if self.controller is not None:
                self.controller.reset_rows(dead_rows)
        return state, qbuf, stall

    # -- host-side pool bookkeeping -----------------------------------------
    def _fresh_pool(self, queries_pool):
        """A pool over the (S, Qs, d) ``queries_pool`` with every row
        parked (``done``): parked rows do no phase work."""
        state = self.stepper.init(self.consts, queries_pool, *self.entry)
        return state._replace(done=torch.ones_like(state.done))

    def _spec_inputs(self, shape):
        """(spec_state, cfg, dynamic) for a chunk: the controller's
        mirrors, or a constant-width 5-tuple when there is none."""
        if self.controller is not None:
            self.controller._ensure(shape)
            return (self.controller.state(self.device), self.controller.cfg,
                    True)
        if self._static_spec is None:
            w = torch.full(shape, self.params.spec_width, dtype=torch.int32,
                           device=self.device)
            z = torch.zeros(shape, dtype=torch.float32, device=self.device)
            self._static_spec = (w, z, z, z, z)
        return self._static_spec, _NULL_CFG, False

    def _warmup(self, queries: np.ndarray, pend) -> tuple[float, int]:
        """Run one chunk of the dispatch path :meth:`run` uses on a
        throwaway pool whose rows are all live (the first queries,
        repeated), so the kernels are built and the chunk captured
        before the serving clock starts, as the reference's warmup
        compiles it. With ``pend`` the staged queue rides along with an
        exhausted cursor (per shard, for per-shard queues): the admission
        stage runs and seats nothing. Returns (seconds, rounds run)."""
        S, Qs = self.S, self.num_slots
        t0 = time.perf_counter()
        fill = np.resize(queries, (S * Qs, queries.shape[1]))
        qw = torch.as_tensor(fill.reshape(S, Qs, -1), device=self.device)
        state = self.stepper.init(self.consts, qw, *self.entry)
        spec_state, cfg, dyn = self._spec_inputs((S, Qs))
        if pend is not None:
            done = pend[1].shape[-1]
            if pend[1].dim() == 2:
                done = np.full(pend[1].shape[0], done, np.int64)
            out = self.stepper.run_chunk_admit(
                self.consts, state, qw, spec_state, cfg, self.round_chunk,
                pend, done, 0, self.entry, dynamic=dyn)
            steps = out[3]
        else:
            out = self.stepper.run_chunk(self.consts, state, qw, spec_state,
                                         cfg, self.round_chunk, False,
                                         dynamic=dyn)
            steps = out[2]
        ids, dists = self._retire(out[0], out[1] if pend is not None
                                  else qw)
        if self.live is not None:
            # an epoch swap's restarts admit on the host on either
            # admission path: run that stage too
            self.stepper.admit(state, qw, torch.zeros_like(state.done), qw,
                               *self.entry)
        steps, _, _ = to_host(steps, ids, dists)
        return time.perf_counter() - t0, int(steps)

    def _stage_routed(self, queries, arrivals, order, target_shards,
                      injit: bool):
        """Per-shard admission queues in arrival order, staged once with
        the Allocator's bucket discipline (core/dispatch.py): shard s's
        queue holds the rows routed to it and is drained by its own
        cursor. Returns (row id per (shard, place) (S, cap), arrival
        rounds per (shard, place) padded with INT32_MAX, which sorts after
        every real arrival, rows per shard, and the device queue when
        ``injit``)."""
        S = self.S
        dest = torch.as_tensor(np.asarray(target_shards, np.int64)[order])
        valid = torch.ones(len(order), dtype=torch.bool)
        rank, counts = compute_ranks(dest, valid, S)
        counts = counts.numpy()
        cap = max(1, int(counts.max()))

        def bucket(x, fill=0):
            return np.ascontiguousarray(scatter_to_buckets(
                dest, rank, valid, torch.as_tensor(x), S, cap,
                fill=fill).numpy())

        legidx = bucket(order.astype(np.int32), fill=INVALID)
        arr_by_shard = bucket(arrivals[order].astype(np.int32),
                              fill=np.iinfo(np.int32).max)
        pend = None
        if injit:
            pend = (to_device(bucket(queries[order]), self.device),
                    to_device(arr_by_shard, self.device))
        return legidx, arr_by_shard, counts, pend

    def run(self, queries: np.ndarray,
            arrivals: Optional[np.ndarray] = None,
            target_shards: Optional[np.ndarray] = None) -> StreamStats:
        """Serve ``queries`` (N, d); ``arrivals`` are arrival rounds
        (default: all at round 0). Returns per-query results + metrics.

        ``target_shards`` (N,) switches to **routed admission** (needs
        ``routed=True`` at construction): row i may only be seated in
        shard ``target_shards[i]``'s slot rows, each shard drains its
        own arrival-ordered queue independently, and a shard with no
        routed work stays parked — the two-tier serving discipline
        (:func:`routed_stream_search` fans queries into per-shard legs
        and fuses their top-k)."""
        queries = np.asarray(queries, np.float32)
        N, d = queries.shape
        arrivals = (np.zeros(N, np.int64) if arrivals is None
                    else np.asarray(arrivals, np.int64))
        order = np.argsort(arrivals, kind="stable")
        routed = target_shards is not None
        if routed and not self.routed:
            raise ValueError("pass routed=True at construction to serve "
                             "per-shard target_shards")
        S, Qs, K = self.S, self.num_slots, self.round_chunk
        dev = self.device
        stepped = idle = dispatches = syncs = 0
        injit = self.injit_admit and N > 0
        # bounded admission ring (flat in-device path only): the device
        # queue is a window of at most `ring` staged queries, copied
        # into the same two buffers at each chunk boundary
        ring = self.ring_capacity if injit and not routed else 0
        staged: list[int] = []        # ring window: qids, arrival order
        shed_qids: list[int] = []     # rejected by the shed policy
        stream_pos = 0                # ring cursor into `order`
        pend = None
        if routed:
            legidx, arr_by_shard, counts, pend = self._stage_routed(
                queries, arrivals, order, target_shards, injit)
            next_qs = np.zeros(S, np.int64)           # per-shard cursors
        elif ring:
            pend = (torch.zeros((ring, d), dtype=torch.float32, device=dev),
                    torch.full((ring,), NEVER, dtype=torch.int32,
                               device=dev))
        elif injit:
            # device-side pending queue, staged once in admission order
            pend = (to_device(queries[order], dev),
                    to_device(arrivals[order].astype(np.int32), dev))
        compile_s, warm_rounds = (self._warmup(queries, pend) if N
                                  else (0.0, 0))
        qbuf = torch.zeros((S, Qs, d), dtype=torch.float32, device=dev)
        state = self._fresh_pool(qbuf)
        owner = np.full((S, Qs), INVALID, np.int64)   # slot -> qid
        admit_t = np.zeros((S, Qs), np.int64)
        admit_wall = np.zeros((S, Qs), np.float64)
        # live index: serving age carried across swap restarts (zeroed at
        # every seat; identically zero without swaps), and its counters
        age_base = np.zeros((S, Qs), np.int64)
        rounds_base = np.zeros((S, Qs), np.int64)
        epoch_swaps = swap_stall = 0
        live_ix = self.live
        if live_ix is not None:
            live_del0, live_hit0 = live_ix.deletes, live_ix.delta_hits
            # mutations made through the API since construction
            self._push_live()
        next_q = 0                                    # cursor into order
        retired = 0
        t = 0
        results: list[QueryResult] = []
        occ_trace: list[int] = []
        spec_trace: list[float] = []
        t0 = time.perf_counter()

        def emit(s, r, ids, dists, rounds, n_dist, age, trunc, now_wall):
            qid = int(owner[s, r])
            ids, dists = ids.copy(), dists.copy()
            if live_ix is not None:
                ids, dists = live_ix.map_result(ids, dists)
            age = age_base[s, r] + age
            rounds = rounds_base[s, r] + rounds
            results.append(QueryResult(
                qid=qid, ids=ids, dists=dists,
                arrival_round=int(arrivals[qid]),
                admit_round=int(admit_t[s, r]),
                retire_round=int(admit_t[s, r] + age),
                service_rounds=int(rounds), n_dist=int(n_dist),
                wall_latency_s=now_wall - admit_wall[s, r],
                truncated=bool(trunc), stall_rounds=int(age - rounds)))
            age_base[s, r] = rounds_base[s, r] = 0

        def next_arrival():
            """Earliest arrival round among unadmitted queries (None once
            every queue is drained)."""
            if routed:
                nas = [arr_by_shard[s, next_qs[s]] for s in range(S)
                       if next_qs[s] < counts[s]]
                return int(min(nas)) if nas else None
            if ring:
                if staged:
                    return int(arrivals[staged[0]])
                return (int(arrivals[order[stream_pos]])
                        if stream_pos < N else None)
            return int(arrivals[order[next_q]]) if next_q < N else None

        def seat_host(mask, new_q):
            nonlocal state, qbuf
            state, qbuf = self.stepper.admit(
                state, qbuf, to_device(mask, dev), to_device(new_q, dev),
                *self.entry)
            if self.controller is not None:
                self.controller.reset_rows(mask)

        while retired + len(shed_qids) < N:
            if live_ix is not None and live_ix.due(t):
                # -- live-index boundary: apply every insert and delete
                # due by the serving clock; a reindex they trigger (a
                # full delta, refresh_every) swaps in here, the one place
                # the pool is between dispatches
                changed, nswaps = live_ix.advance(t)
                if nswaps:
                    epoch_swaps += nswaps
                    state, qbuf, lost = self._swap_epoch(
                        state, qbuf, owner, age_base, rounds_base)
                    swap_stall += lost
                if changed:
                    self._push_live()
            if not injit and routed:
                # -- host-paced routed admission: each shard fills its
                # own free rows from its own arrived queue
                mask = np.zeros((S, Qs), bool)
                new_q = np.zeros((S, Qs, d), np.float32)
                now_wall = time.perf_counter()
                for s in range(S):
                    for r in np.flatnonzero(owner[s] == INVALID):
                        if next_qs[s] >= counts[s] or \
                                arr_by_shard[s, next_qs[s]] > t:
                            break
                        qid = int(legidx[s, next_qs[s]])
                        mask[s, r] = True
                        new_q[s, r] = queries[qid]
                        owner[s, r] = qid
                        admit_t[s, r] = t
                        admit_wall[s, r] = now_wall
                        next_qs[s] += 1
                if mask.any():
                    seat_host(mask, new_q)
            elif not injit:
                # -- host-paced admission: fill free slots from the
                # arrived pending queue
                free = np.argwhere(owner == INVALID)
                can_admit = self.refill or len(free) == S * Qs
                waiting = []
                while (can_admit and len(waiting) < len(free) and next_q < N
                       and arrivals[order[next_q]] <= t):
                    waiting.append(order[next_q])
                    next_q += 1
                if waiting:
                    mask = np.zeros((S, Qs), bool)
                    new_q = np.zeros((S, Qs, d), np.float32)
                    now_wall = time.perf_counter()
                    for (s, r), qid in zip(free[:len(waiting)], waiting):
                        mask[s, r] = True
                        new_q[s, r] = queries[qid]
                        owner[s, r] = qid
                        admit_t[s, r] = t
                        admit_wall[s, r] = now_wall
                    seat_host(mask, new_q)

            live = int((owner != INVALID).sum())
            na = next_arrival()
            if live == 0 and not (injit and na is not None and na <= t):
                # pool idle until the next arrival: jump the serving
                # clock without a dispatch. The skipped rounds are real
                # serving time, so occupancy/throughput count them
                nt = max(t + 1, na) if na is not None else t + 1
                idle += nt - t
                t = nt
                continue

            spec_state, cfg, dyn = self._spec_inputs((S, Qs))
            if injit:
                # -- chunk with in-device admission: full budget; freed
                # slots are reseated at the exact boundary and the
                # admit/evict traces replay the accounting below
                launch_wall = time.perf_counter()
                if ring:
                    # slide the window forward (refill in arrival order
                    # while seats are free), then, shedding, reject every
                    # query that has arrived while the window is full
                    # (judged at chunk boundaries)
                    while len(staged) < ring and stream_pos < N:
                        staged.append(int(order[stream_pos]))
                        stream_pos += 1
                    if self.overload == "shed":
                        while (len(staged) == ring and stream_pos < N
                               and arrivals[order[stream_pos]] <= t):
                            shed_qids.append(int(order[stream_pos]))
                            stream_pos += 1
                    # restage the window into the same buffers (the
                    # capture reads them in place); NEVER-padded tails
                    # sort after every real arrival
                    win = list(staged)
                    wq = np.zeros((ring, d), np.float32)
                    wa = np.full((ring,), NEVER, np.int32)
                    wq[:len(win)] = queries[win]
                    wa[:len(win)] = arrivals[win]
                    pend[0].copy_(to_device(wq, dev))
                    pend[1].copy_(to_device(wa, dev))
                    cursor = 0
                else:
                    cursor = next_qs if routed else next_q
                (state, qbuf, spec_state, steps, live_cnt, width_sum,
                 *extra) = self.stepper.run_chunk_admit(
                    self.consts, state, qbuf, spec_state, cfg, K, pend,
                    cursor, t, self.entry, dynamic=dyn)
            else:
                # -- host-paced admission wakes the chunk exactly when
                # admission could matter. Free slots: nothing can be
                # admitted before the next arrival, so cap the chunk
                # there. Full pool: a finish may seat a waiting or
                # imminent arrival, so stop on the first finish. Routed:
                # a freed row only helps a waiting leg of its own shard,
                # which a global stop-on-finish cannot tell, so pace
                # per round while an arrived leg waits. All keep the
                # schedule identical to round_chunk=1
                budget, stop_on_finish = K, False
                if routed:
                    if na is not None:
                        budget = max(1, min(K, na - t))
                elif self.refill and na is not None:
                    if live < S * Qs:
                        budget = max(1, min(K, na - t))
                    else:
                        stop_on_finish = na <= t + K
                (state, spec_state, steps, live_cnt,
                 width_sum) = self.stepper.run_chunk(
                    self.consts, state, qbuf, spec_state, cfg, budget,
                    stop_on_finish, dynamic=dyn)
                extra = ()
            dispatches += 1
            # the chunk boundary's one transfer: the rounds run, traces,
            # the pool's counters and results, the controller, the admit
            # traces
            fin_i, fin_d = self._retire(state, qbuf)
            ctrl = spec_state if self.controller is not None else ()
            tier = () if self.pagestore is None else (
                state.page_touch, state.page_miss, state.cand_i,
                state.cand_e)
            host = to_host(steps, live_cnt, width_sum, state.done,
                           state.rounds, state.n_dist, state.age,
                           state.truncated, fin_i, fin_d, *ctrl, *tier,
                           *extra)
            syncs += 1
            now_wall = time.perf_counter()
            steps = int(host[0])
            (live_cnt, width_sum, done, rounds, n_dist, age, trunc, out_i,
             out_d) = host[1:10]
            live_cnt, width_sum = live_cnt[:steps], width_sum[:steps]
            if self.controller is not None:
                self.controller.store(host[10:15])
            if tier and steps:
                at = 10 + len(ctrl)
                self._tier_boundary(state, *host[at:at + 4], done, rounds)
            if injit:
                # entries past `steps` are the traces' initial values
                (admit_qidx, ret_i, ret_d, ret_rounds, ret_ndist, ret_age,
                 ret_trunc, cur) = host[-8:]
                for j in range(steps):
                    for s, r in np.argwhere(admit_qidx[j] >= 0):
                        if owner[s, r] != INVALID:
                            # the seated query evicted a finished row:
                            # emit it from the boundary-j capture
                            emit(s, r, ret_i[j, s, r], ret_d[j, s, r],
                                 ret_rounds[j, s, r], ret_ndist[j, s, r],
                                 ret_age[j, s, r], ret_trunc[j, s, r],
                                 now_wall)
                            retired += 1
                        # routed: the index is into shard s's own queue;
                        # ring: into this dispatch's window
                        p = admit_qidx[j, s, r]
                        owner[s, r] = int(legidx[s, p] if routed
                                          else win[p] if ring
                                          else order[p])
                        admit_t[s, r] = t + j
                        admit_wall[s, r] = launch_wall
                        age_base[s, r] = rounds_base[s, r] = 0
                if routed:
                    next_qs = cur.astype(np.int64)
                elif ring:
                    del staged[:int(cur)]     # consumed window seats
                else:
                    next_q = int(cur)
            t += steps
            stepped += steps
            occ_trace.extend(int(c) for c in live_cnt)
            spec_trace.extend(ws / c for ws, c in
                              zip(width_sum, np.maximum(live_cnt, 1)))

            # -- retire finished rows (the chunk already parked rows at
            # the per-query round cap and their deadline, at the exact
            # round boundary the per-round scheduler would have)
            fin = (owner != INVALID) & done
            for s, r in np.argwhere(fin):
                emit(s, r, out_i[s, r], out_d[s, r], rounds[s, r],
                     n_dist[s, r], age[s, r], trunc[s, r], now_wall)
                owner[s, r] = INVALID
            retired += int(fin.sum())

        ps = self.pagestore
        # end-of-session counters: one transfer for the whole summary
        pages_unique, items_recv, props_sent, drops_b, quarantined = to_host(
            state.pages_unique, state.items_recv, state.props_sent,
            state.drops_b, state.quarantined)
        return StreamStats(
            results=results, total_rounds=stepped,
            occupancy=slot_occupancy(occ_trace, S * Qs, stepped + idle),
            occupancy_trace=occ_trace,
            pages_unique=int(pages_unique.sum()),
            items_recv=int(items_recv.sum()),
            props_sent=int(props_sent.sum()),
            drops_b=int(drops_b.sum()),
            spec_trace=spec_trace, wall_s=time.perf_counter() - t0,
            host_dispatches=dispatches, host_syncs=syncs,
            compile_s=compile_s, warmup_rounds=warm_rounds,
            idle_rounds=idle, injit_admit=self.injit_admit,
            items_by_shard=[int(x) for x in items_recv],
            shed=len(shed_qids),
            truncated=sum(1 for r in results if r.truncated),
            quarantined=int(quarantined.sum()),
            stalls=sum(r.stall_rounds for r in results),
            prefetch_hits=ps.prefetch_hits if ps is not None else 0,
            prefetch_issued=ps.prefetch_issued if ps is not None else 0,
            resident_fraction=(ps.resident_fraction if ps is not None
                               else 1.0),
            delta_hits=(live_ix.delta_hits - live_hit0
                        if live_ix is not None else 0),
            tombstoned=(live_ix.deletes - live_del0
                        if live_ix is not None else 0),
            epoch_swaps=epoch_swaps, swap_stall_rounds=swap_stall)

    def _tier_boundary(self, state, touch, miss, cand_i, cand_e, done,
                       rounds) -> None:
        """The tiered store's chunk boundary, on the chunk's one host
        read: fold the touch/miss bitmaps into residency, commit the
        payload staged at the previous boundary (its copy overlapped this
        chunk), demand-fetch the misses and stage the next speculative
        set (core/pagestore.py), all in place in the consts' tensors;
        then zero the state's bitmaps in place.

        Livelock watch: when one round's page working set exceeds the
        cache, every boundary's demand installs evict pages the same
        round still needs; fetches happen (so the store's own
        no-progress guard never fires) but the round never completes. A
        live row whose round counter stays frozen across
        _LIVELOCK_BOUNDARIES consecutive boundaries is that
        configuration error (a legitimate stall clears at the next
        boundary's demand fetch)."""
        self.pagestore.boundary(touch, miss, cand_i, cand_e, done)
        state.page_touch.zero_()
        state.page_miss.zero_()
        if self._stall_count is None:
            self._stall_count = np.zeros(rounds.shape, np.int64)
        else:
            stuck = ~done & (rounds == self._stall_rounds_prev)
            self._stall_count = np.where(stuck, self._stall_count + 1, 0)
            if (self._stall_count >= _LIVELOCK_BOUNDARIES).any():
                raise RuntimeError(
                    "tiered page store livelock: a query made no round "
                    f"progress for {_LIVELOCK_BOUNDARIES} consecutive "
                    "chunk boundaries — device_pages is smaller than a "
                    "single round's page working set on its shard; raise "
                    "--device-pages")
        self._stall_rounds_prev = rounds


def poisson_arrivals(rate: float, n: int, seed: int = 0) -> np.ndarray:
    """Open-loop arrival rounds: ``rate`` mean arrivals per engine
    round (exponential inter-arrival gaps). rate <= 0 -> all at 0.

    Cumulative gaps are rounded half-up to the integer round clock —
    truncation would floor every arrival ~0.5 rounds early, biasing the
    realized arrival rate above the requested one."""
    if rate <= 0:
        return np.zeros(n, np.int64)
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, n)
    return np.floor(np.cumsum(gaps) + 0.5).astype(np.int64)


def _make_controller(params, geom, dynamic_spec, spec_page_w=0.0):
    if not dynamic_spec:
        return None
    if params.spec_width <= 0:
        raise ValueError(
            "dynamic_spec needs a speculation budget to adapt: set "
            "spec_width > 0 (it is the controller's maximum width)")
    return SpecController(spec_max=params.spec_width,
                          W=params.search.W,
                          max_degree=geom.max_degree,
                          page_w=float(spec_page_w))


def stream_search(consts, geom, params, entry, queries,
                  num_slots: int, arrivals=None, mesh=None,
                  dynamic_spec: bool = False, refill: bool = True,
                  round_chunk: int = 1, injit_admit=None,
                  spec_page_w: float = 0.0, ring_capacity: int = 0,
                  overload: str = "block", pagestore=None, live=None,
                  device="cuda", capture: bool = True):
    """Run the streaming scheduler on ``device`` and return (ids (N, k),
    dists (N, k), StreamStats) in query order. ``capture=False`` runs
    the chunks eagerly on a card; with ``mesh``, ``consts`` are this
    rank's shards (see :class:`StreamScheduler`)."""
    ctrl = _make_controller(params, geom, dynamic_spec, spec_page_w)
    sched = StreamScheduler(consts, geom, params, entry,
                            num_slots=num_slots, mesh=mesh,
                            controller=ctrl, refill=refill,
                            round_chunk=round_chunk,
                            injit_admit=injit_admit,
                            ring_capacity=ring_capacity,
                            overload=overload, pagestore=pagestore,
                            live=live, device=device, capture=capture)
    stats = sched.run(queries, arrivals)
    k = params.search.k
    n = np.asarray(queries).shape[0]
    ids = np.full((n, k), INVALID, np.int32)
    dists = np.zeros((n, k), np.float32)
    for r in stats.results:
        ids[r.qid] = r.ids
        dists[r.qid] = r.dists
    return ids, dists, stats


def default_leg_L(n_shard: int, max_degree: int, k: int) -> int:
    """Routed per-leg candidate-list length from per-shard graph depth.

    A Vamana-style leg converges after roughly the shard graph's
    greedy-path depth ``log_R(n_shard)`` hops, each hop displacing at
    most a few frontier entries, so the list needs the k result seats
    plus headroom proportional to that depth, independent of the global
    L the caller tuned for the full graph. ``leg_L`` stays the explicit
    override."""
    depth = math.ceil(math.log(max(n_shard, 2))
                      / math.log(max(max_degree, 2)))
    return k + 2 * depth


def routed_stream_search(consts, geom, params, entry, queries, *,
                         router, topr: int, num_slots: int,
                         arrivals=None, mesh=None,
                         dynamic_spec: bool = False,
                         round_chunk: int = 1, injit_admit=None,
                         shard_entries=None, leg_L=None,
                         spec_page_w: float = 0.0, down_shards=None,
                         live=None, device="cuda", capture: bool = True):
    """Two-tier routed serving (core/router.py) on ``device``: coarse-
    route each query to its top-R shards, serve one *leg* per (query,
    shard) on that shard's independent slot schedule, and fuse the
    per-leg top-k at retire time through the backend's bitonic merge
    tree (on a card, R - 1 launches of the standalone merge kernel).

    ``topr >= num_shards`` degenerates to the all-shard fan-out
    semantics: one leg per query (global proposals, global entry), with
    per-query results bit-identical to :func:`stream_search` — the
    routed layer only changes *where* the row sits. ``topr <
    num_shards`` confines each leg to its home shard's subgraph
    (``local_only``) seeded at that shard's own medoid
    (``shard_entries``, as ``build_routed_index`` builds them), with the
    per-leg candidate list ``leg_L`` long (default
    :func:`default_leg_L`, from the per-shard graph depth).

    Returns (ids (N, k), dists (N, k), StreamStats) in query order;
    ``stats.results`` holds fused per-query records (``n_dist`` summed
    over legs, latency the slowest leg's: a query retires when all its
    legs have) and ``stats.legs`` the slot rows served. With ``mesh``,
    ``consts`` are this rank's shards (``shard_consts``).

    **Degraded fusion** (``down_shards``): legs routed to a shard in
    ``down_shards`` are dropped on the host before scheduling; the
    healthy legs run normally and the query fuses whatever finished,
    reporting ``legs_fused`` / ``coverage`` and ``truncated=True``
    instead of stalling on a shard that will never answer. A shard that
    dies mid-run is the engine's job instead: a kill in
    ``params.faults`` (with ``deadline_rounds``) force-retires its legs
    with best-so-far results, which count as non-clean legs. A query
    whose every leg is down retires at its arrival round with
    all-INVALID ids, coverage 0.
    """
    from repro_torch.core.router import BIG_DIST, fuse_topk

    dev = resolve_device(device)
    queries = np.asarray(queries, np.float32)
    N = queries.shape[0]
    S = geom.num_shards
    k = params.search.k
    arrivals = (np.zeros(N, np.int64) if arrivals is None
                else np.asarray(arrivals, np.int64))
    topr = int(topr)
    if topr < 1:
        raise ValueError(f"topr must be >= 1, got {topr}")
    if live is not None and topr < S:
        # legs on topr < S shard-local subgraphs would each merge the
        # whole delta segment, duplicating delta ids across the fused
        # top-k (and the shard partition itself changes at every swap);
        # only the one-leg-per-query branch is live-safe
        raise ValueError("live index requires topr >= num_shards "
                         "(shard-local legs cannot mask a shared delta)")
    if topr >= S:
        R = 1
        targets = np.asarray(router.route(queries, 1))
        leg_params = params
        evec, enorm, eid = entry
        sh_entry = (evec.expand(S, -1).contiguous(),
                    enorm.reshape(1).expand(S).contiguous(),
                    torch.full((S,), int(eid), dtype=torch.int32,
                               device=evec.device))
    else:
        R = topr
        if shard_entries is None:
            raise ValueError(
                "topr < num_shards needs per-shard entries "
                "(shard_entries; build_routed_index provides them)")
        targets = np.asarray(router.route(queries, R))
        lg = (int(leg_L) if leg_L
              else default_leg_L(geom.n // S, geom.max_degree, k))
        leg_params = dataclasses.replace(
            params,
            search=dataclasses.replace(params.search, L=max(k, lg)),
            local_only=True)
        sh_entry = tuple(torch.as_tensor(a, device=dev)
                         for a in shard_entries)

    # leg rows: query i's leg j is row i*R + j, inheriting the query's
    # vector and arrival and targeting its j-th routed shard
    leg_q = np.repeat(queries, R, axis=0)
    leg_arr = np.repeat(arrivals, R)
    leg_tgt = targets[:, :R].reshape(-1).astype(np.int32)

    # degraded routing: drop legs whose target shard is known-down, so
    # nothing can stall on a dead shard's never-draining queue
    down = np.zeros(S, bool)
    if down_shards is not None:
        ds = np.asarray(down_shards, np.int64).reshape(-1)
        if ds.size and (ds.min() < 0 or ds.max() >= S):
            raise ValueError(f"down_shards must be in [0, {S}), "
                             f"got {sorted(set(ds.tolist()))}")
        down[ds] = True
        if down.all():
            raise ValueError("every shard is down — nothing to serve")
    alive_rows = np.flatnonzero(~down[leg_tgt])
    # leg row id -> its position (= qid) in the scheduled alive subset
    pos_of = {int(row): p for p, row in enumerate(alive_rows)}

    ctrl = _make_controller(leg_params, geom, dynamic_spec, spec_page_w)
    sched = StreamScheduler(consts, geom, leg_params, sh_entry,
                            num_slots=num_slots, mesh=mesh,
                            controller=ctrl, refill=True,
                            round_chunk=round_chunk,
                            injit_admit=injit_admit, routed=True,
                            live=live, device=dev, capture=capture)
    leg_stats = sched.run(leg_q[alive_rows], leg_arr[alive_rows],
                          target_shards=leg_tgt[alive_rows])

    by = leg_stats.by_qid()
    leg_i = np.full((N, R, k), INVALID, np.int32)
    leg_d = np.zeros((N, R, k), np.float32)
    for p, rec in by.items():
        row = int(alive_rows[p])
        leg_i[row // R, row % R] = rec.ids
        leg_d[row // R, row % R] = rec.dists
    if R == 1:
        ids, dists = leg_i[:, 0].copy(), leg_d[:, 0].copy()
        # fuse_topk's padding contract on the degenerate path: a
        # dropped or absent leg reads (INVALID, BIG_DIST), not 0.0
        dists[ids == INVALID] = BIG_DIST
    else:
        di, ii = fuse_topk(leg_d, leg_i, leg_params.backend, device=dev)
        dists, ids = to_host(di, ii)

    results = []
    hist = [0] * (R + 1)       # index f: queries with f clean legs
    for i in range(N):
        legs = [by[pos_of[i * R + j]] for j in range(R)
                if i * R + j in pos_of]
        # a leg is fused cleanly if it ran and converged; a deadlined
        # (truncated) leg still gave its best-so-far candidates, but the
        # query's coverage no longer spans that shard's subgraph
        fused = sum(1 for lr in legs if not lr.truncated)
        hist[fused] += 1
        if legs:
            results.append(QueryResult(
                qid=i, ids=ids[i].copy(), dists=dists[i].copy(),
                arrival_round=int(arrivals[i]),
                admit_round=min(lr.admit_round for lr in legs),
                retire_round=max(lr.retire_round for lr in legs),
                service_rounds=max(lr.service_rounds for lr in legs),
                n_dist=sum(lr.n_dist for lr in legs),
                wall_latency_s=max(lr.wall_latency_s for lr in legs),
                truncated=fused < R, legs_fused=fused,
                coverage=fused / R,
                stall_rounds=sum(lr.stall_rounds for lr in legs)))
        else:
            # every routed shard down: retire at once, empty-handed
            results.append(QueryResult(
                qid=i, ids=ids[i].copy(), dists=dists[i].copy(),
                arrival_round=int(arrivals[i]),
                admit_round=int(arrivals[i]),
                retire_round=int(arrivals[i]), service_rounds=0,
                n_dist=0, wall_latency_s=0.0, truncated=True,
                legs_fused=0, coverage=0.0))
    results.sort(key=lambda r: (r.retire_round, r.qid))
    stats = dataclasses.replace(
        leg_stats, results=results, legs=len(alive_rows),
        truncated=sum(1 for r in results if r.truncated),
        legs_fused_hist=hist,
        stalls=sum(r.stall_rounds for r in results))
    return ids, dists, stats
