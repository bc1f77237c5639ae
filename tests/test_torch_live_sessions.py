"""Whole live-index sessions on the port against the reference's, bit for
bit: tests/test_live.py's fixture (n0 256, d 16, 2 shards, page 8,
degree 8) with integer-valued vectors, queries and insert payloads (a
hand-built ``MutationSchedule``), Poisson inserts and deletes through at
least two epoch swaps, flat (in-device and host-paced admission, the
dynamic controller), half-resident tiered (prefetch on and off) and
routed at topr = S. Each session equals the reference's in
ids, dists, every per-query record, the four live counters and the
final epoch (external ids, tombstones, the delta), and captures its
chunk once (the reference's compile-once tests, as capture-once through
``core.capture.CACHE``): the session's tensors keep their addresses
across every boundary and swap."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import live as JL
from repro.core.engine import EngineParams as JEngineParams
from repro.core.engine import pack_for_engine as j_pack_for_engine
from repro.core.pagestore import PageStore as JPageStore
from repro.core.ref_search import SearchParams as JSearchParams
from repro.core.router import build_live_router as j_build_live_router
from repro.core.scheduler import routed_stream_search as j_routed
from repro.core.scheduler import stream_search as j_stream_search
from repro_torch.core import scheduler as sched_mod
from repro_torch.core.capture import CACHE
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.live import MutationSchedule, build_live_index
from repro_torch.core.pagestore import PageStore
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.router import build_live_router
from repro_torch.core.scheduler import routed_stream_search, stream_search

N0, D, NQ = 256, 16, 12
SHARDS, PAGE, R, DELTA = 2, 8, 8, 4
HORIZON = 60
CPU = dict(device="cpu")
EPOCH = ("vectors", "ext_ids", "tombs", "delta_vec", "delta_norm",
         "delta_live", "delta_ext")
COUNTERS = ("epoch_swaps", "delta_hits", "tombstoned", "swap_stall_rounds",
            "total_rounds", "host_dispatches", "idle_rounds", "stalls")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """Integer vectors and queries, and the reference's mutation schedule
    (inserts 0.3, deletes 0.1 per round) with integer payloads near the
    queries, so that delta rows reach results."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, (N0, D)).astype(np.float32)
    queries = rng.integers(-8, 9, (NQ, D)).astype(np.float32)
    s = JL.mutation_schedule(0.3, 0.1, HORIZON, D, seed=7, ref=db)
    vec = np.zeros_like(s.vec)
    near = queries[rng.integers(0, NQ, s.num_inserts)]
    vec[s.is_ins] = near + rng.integers(-1, 2, near.shape)
    arrivals = np.sort(rng.integers(0, HORIZON, NQ))
    return db, queries, (s.t, s.is_ins, vec), arrivals


def _records(st):
    """Every QueryResult field but the wall time, by qid."""
    return {r.qid: (tuple(r.ids), tuple(r.dists), r.arrival_round,
                    r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.truncated, r.stall_rounds)
            for r in st.results}


def _session(data, pkg: str, mode: str, refresh_every: int):
    """One live session in ``pkg`` ("port" or "ref"): returns (ids,
    dists, stats, live index, the port's PageStore or None)."""
    db, queries, (t, is_ins, vec), arrivals = data
    spec = 2 if mode == "dynamic" else 0
    kw = dict(num_slots=2, arrivals=arrivals, round_chunk=4,
              injit_admit=False if mode == "host_paced" else None,
              dynamic_spec=mode == "dynamic")
    tiered = mode.startswith("tiered")
    lkw = dict(shards=SHARDS, page_size=PAGE, r=R, delta_cap=DELTA, seed=3,
               refresh_every=refresh_every, pref_width=spec)
    if pkg == "ref":
        live = JL.build_live_index(db, schedule=JL.MutationSchedule(
            t=t, is_ins=is_ins, vec=vec), **lkw)
        consts, geom, entry = j_pack_for_engine(live.ep.packed)
        params = dataclasses.replace(JEngineParams.lossless(
            JSearchParams(L=16, W=1, k=8), 2, R, spec_width=spec),
            delta_cap=DELTA)
        ps = None
        if tiered:
            ps = JPageStore(consts, geom, consts["db"].shape[1] // 2,
                            w_select=1, prefetch=mode == "tiered")
            params = dataclasses.replace(params, store_pages=ps.num_pages)
        if mode == "routed":
            live.router = j_build_live_router(live.ep, centroids_per_shard=4,
                                              seed=5)
            return (*j_routed(consts, geom, params, entry, queries,
                              router=live.router, topr=SHARDS, live=live,
                              **kw), live, None)
        return (*j_stream_search(consts, geom, params, entry, queries,
                                 live=live, pagestore=ps, **kw), live, None)
    live = build_live_index(db, schedule=MutationSchedule(
        t=t, is_ins=is_ins, vec=vec), **lkw)
    consts, geom, entry = pack_for_engine(live.ep.packed, host_pages=tiered,
                                          **CPU)
    params = dataclasses.replace(EngineParams.lossless(
        SearchParams(L=16, W=1, k=8), 2, R, spec_width=spec,
        kernel_mode="ref"), delta_cap=DELTA)
    ps = None
    if tiered:
        ps = PageStore(consts, geom, consts["db"].shape[1] // 2, w_select=1,
                       prefetch=mode == "tiered")
        params = dataclasses.replace(params, store_pages=ps.num_pages)
    if mode == "routed":
        live.router = build_live_router(live.ep, centroids_per_shard=4,
                                        seed=5, kernel_mode="ref", **CPU)
        return (*routed_stream_search(consts, geom, params, entry, queries,
                                      router=live.router, topr=SHARDS,
                                      live=live, **kw, **CPU), live, None)
    return (*stream_search(consts, geom, params, entry, queries, live=live,
                           pagestore=ps, **kw, **CPU), live, ps)


@pytest.mark.parametrize("mode,refresh_every", [
    ("flat", 0), ("flat", 6), ("host_paced", 0), ("dynamic", 0),
    ("tiered", 0), ("tiered_no_prefetch", 0), ("routed", 0)])
def test_live_session_matches_reference(data, mode, refresh_every):
    """A session through >= 2 swaps (a full delta, or every 6 mutations)
    equals the reference's bit for bit, and captures its chunk once: the
    session's consts and entry keep their addresses at every boundary
    and swap."""
    seen = []
    push = sched_mod.StreamScheduler._push_live

    def watched(self):
        seen.append({k: v.data_ptr() for k, v in self.consts.items()}
                    | {f"entry{i}": x.data_ptr()
                       for i, x in enumerate(self.entry)})
        return push(self)

    CACHE.reset_stats()
    sched_mod.StreamScheduler._push_live = watched
    try:
        ids, dists, st, live, ps = _session(data, "port", mode,
                                            refresh_every)
    finally:
        sched_mod.StreamScheduler._push_live = push
    jids, jdists, jst, jlive, _ = _session(data, "ref", mode, refresh_every)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(dists, np.asarray(jdists))
    assert _records(st) == _records(jst)
    for name in COUNTERS:
        assert getattr(st, name) == getattr(jst, name), name
    assert st.epoch_swaps >= 2 and st.tombstoned > 0
    for name in EPOCH:
        np.testing.assert_array_equal(getattr(live.ep, name),
                                      getattr(jlive.ep, name), err_msg=name)
    assert live.swaps == jlive.swaps and live.inserts == jlive.inserts
    if mode == "flat":
        # the payloads sit next to the queries: delta rows are served
        # before a swap folds them in
        assert st.delta_hits > 0
    if ps is not None:
        assert ps.counters()["page_misses"] > 0
        assert st.prefetch_issued == jst.prefetch_issued
        assert (ps.prefetch_issued > 0) == (mode == "tiered")
    # capture once per session, its tensors never moved
    assert CACHE.stats.captures == 1, CACHE.stats
    assert len(seen) > 2 and all(p == seen[0] for p in seen)
    assert live.reindex_s > 0.0
