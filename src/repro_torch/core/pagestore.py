"""Tiered page store: a fixed device frame cache over a host cold tier.

The paper's regime is an index that does not fit in fast memory:
traversal reads stream from a capacity tier, and the accelerator hides
that latency by overlapping fetches with compute. Here the per-shard
vector pages (``consts["db"]`` / ``consts["vnorm"]``) live cold in host
memory (pinned on a card, so copies run on the copy engines), and a
fixed **frame buffer** of ``device_pages`` pages per shard is the only
device copy. A translation table ``ttab`` ((S, NP), logical page ->
device frame, -1 when not resident) goes to the engine through
``consts``; the phase-B distance read goes through it
(``KernelBackend.translated_item_distances``), and a non-resident page
stalls its owner queries for the round (the merge is masked and
retried) instead of reading garbage.

Residency changes only at round-chunk boundaries, on the host:

1. *note* — fold the chunk's ``page_touch`` / ``page_miss`` bitmaps
   into hit/miss counters, second-chance (clock) reference bits and
   prefetch-hit attribution.
2. *commit* — install the payload staged at the *previous* boundary
   into its reserved frames. Its copy ran on a side stream while the
   chunk computed; the current stream waits on the copy's event first.
3. *demand* — fetch every page the chunk missed that is still not
   resident, evicting clock victims. This is the on-critical-path tier:
   the copy is queued on the current stream ahead of its install and
   of the next chunk.
4. *stage* — rank non-resident pages by a one-step lookahead over the
   pool's candidate lists (adjacency neighbours weigh 1, stored
   prefetch-list neighbours ``page_w``), reserve frames for the top
   ``prefetch_pages`` per shard and start their copy on the side
   stream. A reserved frame keeps serving its old page until the commit.

The numpy residency logic is the reference's (``src/repro/core/
pagestore.py``), stable argsorts and ``np.add.at`` included, so its
decisions are bit-identical. The device side belongs to this port: the
frame buffers ``frames`` / ``vnf`` and the device ``ttab`` are allocated
once and only ever written in place (``index_copy_``, ``copy_``), so the
consts' addresses, which key the captured chunk programs
(core/capture.py), never change and a session captures its chunk once.

``device_pages >= NP`` is the identity table over a full copy of the
store: every argument the distance kernel sees is the untiered one.
The graph metadata (``adj`` / ``pref``) stays device-resident; only the
vector pages, the term that scales with the dataset, tier.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineGeom
from repro_torch.utils import (ID_SENTINEL, INVALID, HostStaging, to_device,
                               to_host)

# A boundary that demanded pages but could not install a single one
# (every frame pinned or reserved) makes no progress; the owning queries
# would stall forever. This many consecutive no-progress boundaries is a
# configuration error, not a transient.
_NO_PROGRESS_LIMIT = 256
# The predictor scores the expansions of rounds _SKIP to _LOOKAHEAD ahead,
# each round's weight _DECAY times the previous one's (the reference's
# defaults; a page staged at boundary k commits at k + 1 and serves
# chunk k + 2).
_LOOKAHEAD = 16
_SKIP = 0
_DECAY = 0.95


class PageStore:
    """Host-side residency manager for the tiered page store, with the
    frame buffers on the consts' device.

    Parameters
    ----------
    consts : dict
        The engine consts (full, untiered; ``pack_for_engine``). The
        store runs where the graph arrays live: its frame buffers and
        ``ttab`` go to ``consts["adj"]``'s device. ``db`` / ``vnorm`` are
        copied to host memory as the cold tier (pinned when the store
        runs on a card); build them there
        (``pack_for_engine(..., host_pages=True)``) so that the full
        store never lands on the card. ``adj`` / ``pref`` / ``blk_perm``
        are kept as host copies for the prefetch predictor.
    geom : EngineGeom
        Placement arithmetic (in numpy here, for the predictor).
    device_pages : int
        Frames per shard (``P_dev``), clamped to ``NP``; ``>= NP`` is the
        identity configuration.
    w_select : int
        The engine's selection width W: the lookahead expands the first
        W unexpanded candidates per row per round, as ``_fa_select``.
    prefetch : bool
        False = demand-only fetching.
    page_w : float
        Weight of stored prefetch-list neighbours in the prediction
        score (adjacency neighbours weigh 1).
    prefetch_pages : int | None
        Staged pages per shard per boundary; default ``max(1,
        P_dev // 4)``.
    """

    def __init__(self, consts, geom: EngineGeom, device_pages: int, *,
                 w_select: int, prefetch: bool = True,
                 page_w: float = 1.0, prefetch_pages: int | None = None):
        db = consts["db"]
        self.device = consts["adj"].device
        self.cuda = self.device.type == "cuda"
        self.S, self.NP, self.P, self.d = db.shape
        if device_pages < 1:
            raise ValueError("device_pages must be >= 1")
        self.cold_db = torch.empty(db.shape, dtype=db.dtype,
                                   pin_memory=self.cuda)
        self.cold_vn = torch.empty(consts["vnorm"].shape,
                                   dtype=consts["vnorm"].dtype,
                                   pin_memory=self.cuda)
        self._adopt(consts)
        self.P_dev = int(min(device_pages, self.NP))
        self.geom = geom
        self.W = int(w_select)
        self.prefetch = bool(prefetch)
        self.page_w = float(page_w)
        self.budget = int(prefetch_pages if prefetch_pages
                          else max(1, self.P_dev // 4))

        # residency state: the identity prefix is resident at startup
        self.ttab = np.full((self.S, self.NP), -1, np.int32)
        self.ttab[:, :self.P_dev] = np.arange(self.P_dev, dtype=np.int32)
        self.frame_page = np.tile(
            np.arange(self.P_dev, dtype=np.int32), (self.S, 1))
        self.ref = np.zeros((self.S, self.P_dev), bool)
        self.hand = np.zeros((self.S,), np.int64)
        self.by_prefetch = np.zeros((self.S, self.P_dev), bool)
        self.reserved = np.zeros((self.S, self.P_dev), bool)
        self._staged = None          # (meta, copy event)
        self._no_progress = 0

        self.page_hits = 0
        self.page_misses = 0
        self.demand_fetches = 0
        self.prefetch_issued = 0
        self.prefetch_hits = 0

        # device side: allocated once, written in place from here on
        dev = self.device
        self.frames = torch.empty((self.S, self.P_dev, self.P, self.d),
                                  dtype=self.cold_db.dtype, device=dev)
        self.frames.copy_(self.cold_db[:, :self.P_dev])
        self.vnf = torch.empty((self.S, self.P_dev, self.P),
                               dtype=self.cold_vn.dtype, device=dev)
        self.vnf.copy_(self.cold_vn[:, :self.P_dev])
        self.ttab_dev = torch.empty((self.S, self.NP), dtype=torch.int32,
                                    device=dev)
        payload = [((self.P, self.d), self.cold_db.dtype),
                   ((self.P,), self.cold_vn.dtype)]
        self._demand_buf = HostStaging(payload, self.cuda)
        self._stage_buf = HostStaging(payload, self.cuda)
        self._ttab_buf = HostStaging([((self.S, self.NP), torch.int32)],
                                     self.cuda)
        self._stage_dev = None       # device landing buffers of the stage
        self._side = torch.cuda.Stream(dev) if self.cuda else None
        self._push_ttab()

    def _adopt(self, consts) -> None:
        """Take ``consts``' pages as the cold tier (into the same host
        buffers) and its graph arrays for the predictor."""
        self.cold_db.copy_(consts["db"])
        self.cold_vn.copy_(consts["vnorm"])
        self.adj, self.pref, self.blk_perm = to_host(
            consts["adj"], consts["pref"], consts["blk_perm"])

    # -- geometry (numpy versions of EngineGeom's tensor arithmetic) -------
    def _owner(self, vid):
        gp = vid // self.geom.page_size
        if self.geom.stripe == "striped":
            return (gp % self.S).astype(np.int32)
        return (gp // self.geom.pages_per_shard).astype(np.int32)

    def _local_page(self, vid):
        gp = vid // self.geom.page_size
        if self.geom.stripe == "striped":
            return gp // self.S
        return gp % self.geom.pages_per_shard

    def _phys_page(self, vid, owner):
        ppb = self.geom.pages_per_block
        lpage = self._local_page(vid)
        blk = np.clip(lpage // ppb, 0, self.blk_perm.shape[1] - 1)
        return self.blk_perm[owner, blk] * ppb + lpage % ppb

    # -- public surface ---------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.NP

    @property
    def resident_fraction(self) -> float:
        return self.P_dev / self.NP

    def device_view(self):
        """Consts overrides: the frame buffers and the translation table
        (the same tensors for the store's whole life)."""
        return {"db": self.frames, "vnorm": self.vnf, "ttab": self.ttab_dev}

    def counters(self):
        return {"page_hits": int(self.page_hits),
                "page_misses": int(self.page_misses),
                "demand_fetches": int(self.demand_fetches),
                "prefetch_issued": int(self.prefetch_issued),
                "prefetch_hits": int(self.prefetch_hits)}

    def swap_epoch(self, consts):
        """Epoch swap (live index): adopt a new epoch's cold tier and
        restage every resident frame from it, in place: no new device
        tensor, no shape change. Residency (ttab / frame_page / clock
        state) is kept: the same *pages* stay resident, now with the new
        epoch's contents. A staged payload of the old epoch is dropped
        and its reservations released (it would commit stale bytes).
        Returns the consts overrides."""
        if tuple(consts["db"].shape) != tuple(self.cold_db.shape):
            raise ValueError(
                f"epoch swap changed the store shape: "
                f"{tuple(consts['db'].shape)} != {tuple(self.cold_db.shape)}"
                " (pack every epoch at the session capacity)")
        self._staged = None
        self.reserved[:] = False
        self._adopt(consts)
        rows = [(s, int(self.frame_page[s, f]), f)
                for s in range(self.S) for f in range(self.P_dev)
                if self.frame_page[s, f] >= 0]
        if rows:
            self._install(rows, *self._fetch(rows))
        return self.device_view()

    def boundary(self, touch, miss, cand_i, cand_e, done):
        """Process one round-chunk boundary; returns consts overrides.

        ``touch`` / ``miss``: (S, NP) bool bitmaps the engine accumulated
        since the last boundary. ``cand_i`` / ``cand_e`` / ``done``: the
        pool state the predictor looks ahead from. Arrays or host
        tensors."""
        touch = np.asarray(touch)
        miss = np.asarray(miss)
        pinned = np.zeros((self.S, self.P_dev), bool)

        self._note(touch)
        self.page_misses += int(miss.sum())
        self._commit(pinned)
        demand_s = np.zeros((self.S,), np.int64)
        installed = self._demand(miss, pinned, demand_s)
        if miss.any() and not installed:
            self._no_progress += 1
            if self._no_progress >= _NO_PROGRESS_LIMIT:
                raise RuntimeError(
                    "tiered page store made no demand-fetch progress for "
                    f"{_NO_PROGRESS_LIMIT} boundaries (device_pages too "
                    "small for the per-boundary working set)")
        else:
            self._no_progress = 0
        # the table goes to the card ahead of the stage's copy: copies to
        # the card run in the order they were queued on the copy engine,
        # so a table queued after the stage would hold the next chunk
        # back until the whole prefetch had landed (staging leaves the
        # table as it is)
        self._push_ttab()
        if self.prefetch:
            self._stage(np.asarray(cand_i), np.asarray(cand_e),
                        np.asarray(done), pinned, demand_s)
        return self.device_view()

    # -- device transfers -------------------------------------------------
    def _fetch(self, rows):
        """Gather the cold pages of ``rows`` ((s, page, f) triples) into
        the demand staging buffer and copy them to the device on the
        current stream (the critical path: the next chunk is queued
        behind the copy). Returns the device payload."""
        db_h, vn_h = self._gather(rows, self._demand_buf)
        db_d = db_h.to(self.device, non_blocking=True)
        vn_d = vn_h.to(self.device, non_blocking=True)
        self._demand_buf.sent(self._current())
        return db_d, vn_d

    def _gather(self, rows, buf):
        db_h, vn_h = buf.take(len(rows))
        src = torch.as_tensor([s * self.NP + page for s, page, _ in rows],
                              dtype=torch.long)
        torch.index_select(self.cold_db.view(-1, self.P, self.d), 0, src,
                           out=db_h)
        torch.index_select(self.cold_vn.view(-1, self.P), 0, src, out=vn_h)
        return db_h, vn_h

    def _install(self, rows, db_d, vn_d) -> None:
        """Write a device payload into its (shard, frame) slots, in
        place (the frame buffers keep their addresses)."""
        dst = to_device(np.asarray([s * self.P_dev + f for s, _, f in rows],
                                   np.int64), self.device)
        self.frames.view(-1, self.P, self.d).index_copy_(0, dst, db_d)
        self.vnf.view(-1, self.P).index_copy_(0, dst, vn_d)

    def _push_ttab(self) -> None:
        """Refresh the device translation table in place from the host's.
        The host rewrites ``self.ttab`` right after, so the copy reads a
        staging snapshot, which the next push waits on before reuse."""
        (snap,) = self._ttab_buf.take(1)
        snap[0].copy_(torch.from_numpy(self.ttab))
        self.ttab_dev.copy_(snap[0], non_blocking=True)
        self._ttab_buf.sent(self._current())

    def _current(self):
        return torch.cuda.current_stream(self.device) if self.cuda else None

    # -- boundary stages --------------------------------------------------
    def _note(self, touch):
        self.page_hits += int(touch.sum())
        for s in range(self.S):
            f = self.ttab[s, touch[s]]
            f = f[f >= 0]
            self.prefetch_hits += int(self.by_prefetch[s, f].sum())
            self.by_prefetch[s, f] = False
            self.ref[s, f] = True

    def _commit(self, pinned):
        if self._staged is None:
            return
        meta, event = self._staged
        self._staged = None
        if event is not None:        # the side stream's copy landed
            self._current().wait_event(event)
        n = len(meta)
        self._install(meta, self._stage_dev[0][:n], self._stage_dev[1][:n])
        for s, page, f in meta:
            old = self.frame_page[s, f]
            if old >= 0:
                self.ttab[s, old] = -1
            self.frame_page[s, f] = page
            self.ttab[s, page] = f
            self.by_prefetch[s, f] = True
            self.reserved[s, f] = False
            self.ref[s, f] = False
            pinned[s, f] = True

    def _victim(self, s, pinned):
        """Second-chance clock over shard s's frames; -1 if all pinned."""
        for _ in range(2 * self.P_dev + 1):
            f = int(self.hand[s] % self.P_dev)
            self.hand[s] += 1
            if pinned[s, f] or self.reserved[s, f]:
                continue
            if self.ref[s, f]:
                self.ref[s, f] = False
                continue
            return f
        return -1

    def _install_meta(self, s, page, f):
        old = self.frame_page[s, f]
        if old >= 0:
            self.ttab[s, old] = -1
        self.frame_page[s, f] = page
        self.ttab[s, page] = f
        self.by_prefetch[s, f] = False
        self.ref[s, f] = True

    def _demand(self, miss, pinned, demand_s):
        rows = []
        for s in range(self.S):
            for page in np.nonzero(miss[s] & (self.ttab[s] < 0))[0]:
                f = self._victim(s, pinned)
                if f < 0:
                    break
                self._install_meta(s, int(page), f)
                pinned[s, f] = True
                demand_s[s] += 1
                rows.append((s, int(page), f))
        if not rows:
            return False
        self._install(rows, *self._fetch(rows))
        self.demand_fetches += len(rows)
        return True

    def _stage(self, cand_i, cand_e, done, pinned, demand_s):
        """Score-guided staging: a speculative page may only displace a
        frame whose own page scores strictly lower, and never a frame
        touched in the chunk just finished (``ref``) or pinned/reserved
        this boundary: an incoming page that ranks below everything
        resident is not worth a fetch.

        Pressure throttle: each demand install this boundary consumed
        cache slack on its shard, so the speculative budget backs off by
        twice that count; under thrash speculation only adds churn."""
        score = self._predict(cand_i, cand_e, done)
        meta = []
        for s in range(self.S):
            bud = self.budget - 2 * int(demand_s[s])
            if bud <= 0:
                continue
            sc = score[s].copy()
            sc[self.ttab[s] >= 0] = 0.0          # already resident
            cands = np.argsort(-sc, kind="stable")[:bud]
            cands = [int(p) for p in cands if sc[p] > 0.0]
            if not cands:
                continue
            evictable = np.flatnonzero(~pinned[s] & ~self.reserved[s]
                                       & ~self.ref[s])
            if evictable.size == 0:
                continue
            fscore = score[s][self.frame_page[s, evictable]]
            forder = evictable[np.argsort(fscore, kind="stable")]
            for page, f in zip(cands, forder):
                if sc[page] <= score[s][self.frame_page[s, f]]:
                    break    # both lists sorted: no later pair wins
                # reserve only: the frame keeps serving its old page
                # until the commit at the next boundary
                self.reserved[s, int(f)] = True
                meta.append((s, page, int(f)))
        if not meta:
            return
        self._staged = (meta, self._copy_staged(meta))
        self.prefetch_issued += len(meta)

    def _copy_staged(self, meta):
        """Start the staged payload's copy into the device landing
        buffers; on a card it runs on the side stream, overlapping the
        next chunk. Returns its completion event (None on the CPU)."""
        db_h, vn_h = self._gather(meta, self._stage_buf)
        if self._stage_dev is None:
            rows = self.S * self.budget       # the most one stage holds
            self._stage_dev = (
                torch.empty((rows, self.P, self.d), dtype=db_h.dtype,
                            device=self.device),
                torch.empty((rows, self.P), dtype=vn_h.dtype,
                            device=self.device))
        n = len(meta)
        if not self.cuda:
            self._stage_dev[0][:n].copy_(db_h)
            self._stage_dev[1][:n].copy_(vn_h)
            return None
        # the landing buffers' last readers (the previous commit's
        # installs) are queued on the current stream
        self._side.wait_stream(self._current())
        with torch.cuda.stream(self._side):
            self._stage_dev[0][:n].copy_(db_h, non_blocking=True)
            self._stage_dev[1][:n].copy_(vn_h, non_blocking=True)
        self._stage_buf.sent(self._side)
        return self._stage_buf.event

    def _predict(self, cand_i, cand_e, done):
        """Expansion-queue lookahead -> (S, NP) page demand score.

        ``_fa_select`` expands the W best *unexpanded* candidates and the
        lists are distance-sorted, so the unexpanded candidate at rank r
        is, to first order, the expansion ``r // W`` rounds from now, and
        the pages its adjacency row (weight 1) and stored prefetch list
        (weight ``page_w``) live on are what phase B reads that round.
        Scoring the next ``_LOOKAHEAD`` rounds of this queue with a
        per-round ``_DECAY`` predicts the read set over the double
        buffer's latency without walking the graph.
        """
        score = np.zeros((self.S, self.NP), np.float64)
        valid = ((cand_i != ID_SENTINEL) & ~cand_e
                 & ~done[:, :, None])                    # (S, Qs, L)
        rank = np.cumsum(valid, axis=-1) - 1
        W = max(self.W, 1)
        # ranks below _SKIP rounds expand before a staged page could
        # arrive: their pages are the demand path's job
        pick = (valid & (rank >= _SKIP * W) & (rank < _LOOKAHEAD * W))
        vids = cand_i[pick].astype(np.int64)
        wts = _DECAY ** (rank[pick] // W).astype(np.float64)
        ok = (vids >= 0) & (vids < self.geom.n)
        vids, wts = vids[ok], wts[ok]
        if vids.size == 0:
            return score
        own = self._owner(vids)
        lslot = np.clip(self._local_page(vids) * self.geom.page_size
                        + vids % self.geom.page_size,
                        0, self.adj.shape[1] - 1)
        for nbrs, pw in ((self.adj[own, lslot], 1.0),
                         (self.pref[own, lslot], self.page_w)):
            if pw <= 0.0:
                continue
            nn = nbrs.astype(np.int64)                   # (V, R)
            nw = np.broadcast_to(wts[:, None] * pw, nn.shape)
            m = (nn != INVALID) & (nn >= 0) & (nn < self.geom.n)
            nn, nw = nn[m], nw[m]
            if nn.size == 0:
                continue
            no = self._owner(nn)
            pp = np.clip(self._phys_page(nn, no), 0, self.NP - 1)
            np.add.at(score, (no, pp), nw)
        return score
