"""The tiered page store (core/pagestore.py and the scheduler's chunk
boundary) on the port against the reference's: twins of
tests/test_pagestore.py (full-residency bit-identity, the same results
on a slower clock at partial residency, stall accounting, the livelock
guard, eviction, prefetch-hit attribution, the configuration checks),
whole half-resident sessions bit for bit against the reference in jnp
mode (every per-query record, stalls, the store's counters and final
residency), the epoch swap, and one capture per session."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.engine import EngineParams as JEngineParams
from repro.core.engine import pack_for_engine as j_pack_for_engine
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.pagestore import PageStore as JPageStore
from repro.core.ref_search import SearchParams as JSearchParams
from repro.core.scheduler import stream_search as j_stream_search
from repro_torch.core.capture import CACHE
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.pagestore import PageStore
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import StreamScheduler, stream_search

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _as_port_index(packed) -> PackedIndex:
    g = packed.geometry
    return PackedIndex.from_arrays(
        db=packed.db, vnorm=packed.vnorm, adj=packed.adj,
        adj_owner=packed.adj_owner, pref=packed.pref,
        pref_owner=packed.pref_owner, blk_perm=packed.blk_perm,
        entry=packed.entry, n=packed.n, max_degree=packed.max_degree,
        num_shards=g.num_shards, page_size=g.page_size,
        pages_per_block=g.pages_per_block, dim=g.dim, stripe=g.stripe)


@pytest.fixture(scope="module")
def built():
    """tests/test_pagestore.py's integer index, built by the reference:
    n 1024, d 32, 4 shards, 8-vector pages (32 pages per shard)."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(1024, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(12, 32)).astype(np.float32)
    adj, medoid = j_vamana(db, r=8, alpha=1.2, seed=0)
    geo = JGeometry(num_shards=4, page_size=8, pages_per_block=2, dim=32)
    index = JLUNCSR.from_adjacency(db, adj, geo, entry=medoid, pref_width=2)
    return db, queries, j_pack_index(index, max_degree=8)


@pytest.fixture(scope="module")
def ds(built):
    _, queries, packed = built
    return queries, pack_for_engine(_as_port_index(packed), **CPU)


@pytest.fixture(scope="module")
def ref_engine(built):
    return j_pack_for_engine(built[2])


def _params(geom, slots=2, spec=2, store=0):
    return EngineParams.lossless(SearchParams(L=8, W=1, k=5), slots,
                                 geom.max_degree, spec_width=spec,
                                 kernel_mode="ref", store_pages=store)


def _run(ds, *, pagestore=None, slots=2, chunk=2, arrivals=None, spec=2,
         **kw):
    queries, (consts, geom, entry) = ds
    store = consts["db"].shape[1] if pagestore is not None else 0
    return stream_search(consts, geom, _params(geom, slots, spec, store),
                         entry, queries, num_slots=slots, round_chunk=chunk,
                         arrivals=arrivals, pagestore=pagestore, **kw, **CPU)


def _jrun(ds, ref_engine, *, pagestore=None, slots=2, chunk=2,
          arrivals=None, spec=2, **kw):
    queries = ds[0]
    consts, geom, entry = ref_engine
    params = JEngineParams.lossless(JSearchParams(L=8, W=1, k=5), slots,
                                    geom.max_degree, spec_width=spec)
    if pagestore is not None:
        params = dataclasses.replace(params,
                                     store_pages=consts["db"].shape[1])
    return j_stream_search(consts, geom, params, entry, queries,
                           num_slots=slots, round_chunk=chunk,
                           arrivals=arrivals, pagestore=pagestore, **kw)


def _store(ds, device_pages, **kw):
    consts, geom, _ = ds[1]
    return PageStore(consts, geom, device_pages, w_select=1, **kw)


def _jstore(ref_engine, device_pages, **kw):
    consts, geom, _ = ref_engine
    return JPageStore(consts, geom, device_pages, w_select=1, **kw)


def _num_pages(ds):
    return ds[1][0]["db"].shape[1]


def _schedule(st):
    return {r.qid: (r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist) for r in st.results}


def _records(st):
    """Every QueryResult field but the wall time, by qid."""
    return {r.qid: (tuple(r.ids), tuple(r.dists), r.arrival_round,
                    r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.truncated, r.stall_rounds)
            for r in st.results}


def _assert_same_session(got, want, ps, jps):
    """A port session and the reference's, bit for bit: results, every
    per-query record, the clock, the store's counters and its final
    residency."""
    (ids, dists, st), (jids, jdists, jst) = got, want
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(dists, np.asarray(jdists))
    assert _records(st) == _records(jst)
    for field in ("total_rounds", "stalls", "prefetch_hits",
                  "prefetch_issued", "resident_fraction", "host_dispatches",
                  "pages_unique", "items_recv", "props_sent"):
        assert getattr(st, field) == getattr(jst, field), field
    assert ps.counters() == jps.counters()
    np.testing.assert_array_equal(ps.ttab, jps.ttab)
    np.testing.assert_array_equal(ps.frame_page, jps.frame_page)
    np.testing.assert_array_equal(ps.ttab_dev.numpy(), ps.ttab)
    assert st.host_syncs == st.host_dispatches


# ---------------------------------------------------------------------------
# Full residency (P_dev >= NP) is the identity configuration
# ---------------------------------------------------------------------------
def test_full_residency_bitidentical_property(ds):
    """Hypothesis: any arrival spacing and any cache size at or above the
    page count give results, schedule and dispatch count bit-identical
    to the device-resident path (slot/chunk shapes pinned to two
    configurations, as in the reference's property)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st_

    nq = ds[0].shape[0]
    NP = _num_pages(ds)

    @given(st_.sampled_from([(2, 2), (1, 4)]),
           st_.sampled_from([0, 3]),
           st_.lists(st_.integers(0, 6), min_size=nq, max_size=nq))
    @settings(max_examples=6, deadline=None)
    def check(shape, extra, gaps):
        slots, chunk = shape
        arrivals = np.cumsum(gaps).astype(np.int64)
        ref_i, ref_d, ref_st = _run(ds, slots=slots, chunk=chunk,
                                    arrivals=arrivals)
        ps = _store(ds, NP + extra)
        ids, dists, st = _run(ds, pagestore=ps, slots=slots, chunk=chunk,
                              arrivals=arrivals)
        np.testing.assert_array_equal(ids, ref_i)
        np.testing.assert_array_equal(dists, ref_d)
        assert st.total_rounds == ref_st.total_rounds
        assert st.host_dispatches == ref_st.host_dispatches
        assert _schedule(st) == _schedule(ref_st)
        assert st.stalls == 0
        assert all(r.stall_rounds == 0 for r in st.results)
        assert ps.counters()["page_misses"] == 0
        assert ps.counters()["demand_fetches"] == 0
        assert st.resident_fraction == 1.0

    check()


@pytest.mark.parametrize("prefetch", [False, True])
def test_partial_residency_same_results_slower_clock(ds, ref_engine,
                                                     prefetch):
    """Half the pages resident: the final results equal the untiered
    path's (stalls delay, never corrupt), every stall shows up in some
    query's stall_rounds, and the whole session equals the reference's
    bit for bit."""
    ref_i, ref_d, _ = _run(ds)
    NP = _num_pages(ds)
    ps = _store(ds, NP // 2, prefetch=prefetch)
    got = _run(ds, pagestore=ps)
    ids, dists, st = got
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert st.stalls > 0
    assert st.stalls == sum(r.stall_rounds for r in st.results)
    c = ps.counters()
    assert c["page_misses"] > 0 and c["demand_fetches"] > 0
    if prefetch:
        assert 0 < c["prefetch_hits"] <= c["prefetch_issued"]
    else:
        assert c["prefetch_issued"] == 0 and c["prefetch_hits"] == 0
    jps = _jstore(ref_engine, NP // 2, prefetch=prefetch)
    _assert_same_session(got, _jrun(ds, ref_engine, pagestore=jps), ps, jps)


@pytest.mark.parametrize("prefetch", [False, True])
def test_host_paced_session_matches_reference(ds, ref_engine, prefetch):
    """Host-paced admission (the boundary hook's other path), Poisson-
    like arrivals, half residency: the reference's session bit for
    bit."""
    NP = _num_pages(ds)
    arrivals = np.random.default_rng(1).integers(0, 10, ds[0].shape[0])
    ps = _store(ds, NP // 2, prefetch=prefetch)
    jps = _jstore(ref_engine, NP // 2, prefetch=prefetch)
    kw = dict(arrivals=arrivals, injit_admit=False)
    _assert_same_session(_run(ds, pagestore=ps, **kw),
                         _jrun(ds, ref_engine, pagestore=jps, **kw), ps, jps)


def test_stall_accounting_stretches_clock_not_service(ds):
    """A stalled round is masked, not re-done: service_rounds equal the
    untiered service time, and the residency span stretches by exactly
    the query's own stalls."""
    _, _, ref_st = _run(ds)
    ps = _store(ds, _num_pages(ds) // 2, prefetch=False)
    _, _, st = _run(ds, pagestore=ps)
    assert st.stalls > 0
    ref_srv = {r.qid: r.service_rounds for r in ref_st.results}
    for r in st.results:
        assert r.stall_rounds >= 0
        assert r.service_rounds == ref_srv[r.qid]
        assert r.retire_round - r.admit_round == \
            r.service_rounds + r.stall_rounds


def test_livelock_guard_raises(ds, ref_engine):
    """A cache smaller than one round's page working set never completes
    that round: the scheduler raises the reference's configuration
    error instead of hanging."""
    with pytest.raises(RuntimeError, match="tiered page store") as got:
        _run(ds, pagestore=_store(ds, 2, prefetch=False))
    with pytest.raises(RuntimeError) as want:
        _jrun(ds, ref_engine, pagestore=_jstore(ref_engine, 2,
                                                prefetch=False))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Residency metadata: eviction keeps ttab <-> frame_page a bijection and
# the frame payload equal to the cold tier
# ---------------------------------------------------------------------------
def _check_consistent(ps):
    for s in range(ps.S):
        resident = np.flatnonzero(ps.ttab[s] >= 0)
        frames = ps.ttab[s, resident]
        assert len(set(frames.tolist())) == len(frames)  # injective
        assert (ps.frame_page[s, frames] == resident).all()
        occupied = np.flatnonzero(ps.frame_page[s] >= 0)
        assert set(frames.tolist()) == set(occupied.tolist())


def _check_frames(ps):
    """Every resident page's frame holds its cold-tier rows, and the
    device table is the host's."""
    for s in range(ps.S):
        for page in np.flatnonzero(ps.ttab[s] >= 0):
            f = ps.ttab[s, page]
            assert torch.equal(ps.frames[s, f], ps.cold_db[s, page])
            assert torch.equal(ps.vnf[s, f], ps.cold_vn[s, page])
    np.testing.assert_array_equal(ps.ttab_dev.numpy(), ps.ttab)


def _no_cands(S, Qs=2, L=4):
    return (np.full((S, Qs, L), -1, np.int32),
            np.zeros((S, Qs, L), bool), np.ones((S, Qs), bool))


def test_eviction_correctness(ds, ref_engine):
    """Demand-fetching more pages than frames forces eviction: the table
    stays a bijection, demanded pages land resident, displaced pages
    unmap, the frames equal the cold tier row for row, a page touched
    this chunk keeps its frame, and every step's residency is the
    reference store's."""
    NP, pdev = _num_pages(ds), 4
    ps = _store(ds, pdev, prefetch=False)
    jps = _jstore(ref_engine, pdev, prefetch=False)
    S = ps.S
    touch = np.zeros((S, NP), bool)
    miss = np.zeros((S, NP), bool)
    want = list(range(pdev, pdev + 3))        # 3 non-resident pages
    miss[0, want] = True
    for store in (ps, jps):
        store.boundary(touch, miss, *_no_cands(S))
    _check_consistent(ps)
    assert (ps.ttab[0, want] >= 0).all()
    assert ps.counters()["demand_fetches"] == 3
    assert (ps.ttab[0] >= 0).sum() == pdev    # capacity held: 3 evicted
    _check_frames(ps)
    np.testing.assert_array_equal(ps.ttab, jps.ttab)

    touch2 = np.zeros((S, NP), bool)
    touch2[0, want[0]] = True
    miss2 = np.zeros((S, NP), bool)
    miss2[0, pdev + 3] = True                 # one more demand
    for store in (ps, jps):
        store.boundary(touch2, miss2, *_no_cands(S))
    _check_consistent(ps)
    assert ps.ttab[0, want[0]] >= 0, "touched page was evicted"
    assert ps.ttab[0, pdev + 3] >= 0
    _check_frames(ps)
    np.testing.assert_array_equal(ps.ttab, jps.ttab)
    np.testing.assert_array_equal(ps.frame_page, jps.frame_page)
    assert ps.counters() == jps.counters()


def test_prefetch_hit_counting_fixed_traversal(ds):
    """stage -> commit -> touch: a staged page becomes resident only at
    the next boundary (double buffering), its first touch counts one
    prefetch hit and later touches none; the committed frame holds the
    page's cold rows."""
    NP = _num_pages(ds)
    ps = _store(ds, NP // 2, prefetch_pages=2)
    target = NP - 1                           # not resident at startup
    assert ps.ttab[0, target] < 0
    score = np.zeros((ps.S, NP))
    score[0, target] = 5.0
    ps._predict = lambda *a: score            # a fixed traversal signal
    S = ps.S
    no_cands = _no_cands(S, 1)
    quiet = np.zeros((S, NP), bool)

    ps.boundary(quiet, quiet, *no_cands)      # stages target
    assert ps.counters()["prefetch_issued"] == 1
    assert ps.ttab[0, target] < 0             # staged, not yet resident
    ps.boundary(quiet, quiet, *no_cands)      # commits target
    _check_consistent(ps)
    f = ps.ttab[0, target]
    assert f >= 0 and ps.by_prefetch[0, f]
    _check_frames(ps)
    touch = np.zeros((S, NP), bool)
    touch[0, target] = True
    ps.boundary(touch, quiet, *no_cands)      # first use: one hit
    assert ps.counters()["prefetch_hits"] == 1
    ps.boundary(touch, quiet, *no_cands)      # reuse: no double count
    assert ps.counters()["prefetch_hits"] == 1
    assert ps.counters()["page_misses"] == 0


def test_store_requires_matching_scheduler_config(ds):
    """The scheduler validates the params <-> store pairing with the
    reference's messages: tiered params without a store, a store with
    another page count or shard count, a routed pool or a mesh."""
    queries, (consts, geom, entry) = ds
    NP = _num_pages(ds)
    params = _params(geom)
    tiered = dataclasses.replace(params, store_pages=NP)
    with pytest.raises(ValueError, match="pagestore"):
        stream_search(consts, geom, tiered, entry, queries, num_slots=2,
                      **CPU)
    ps = _store(ds, NP)
    with pytest.raises(ValueError, match="store_pages"):
        stream_search(consts, geom, params, entry, queries, num_slots=2,
                      pagestore=ps, **CPU)
    with pytest.raises(ValueError, match="routed serving does not"):
        StreamScheduler(consts, geom, tiered, entry, 2, routed=True,
                        pagestore=ps, **CPU)
    with pytest.raises(ValueError, match="mesh must be None"):
        StreamScheduler(consts, geom, tiered, entry, 2, mesh=object(),
                        pagestore=ps, **CPU)
    ps.S += 1
    with pytest.raises(ValueError, match="shards"):
        StreamScheduler(consts, geom, tiered, entry, 2, pagestore=ps, **CPU)
    with pytest.raises(ValueError, match="device_pages"):
        _store(ds, 0)
    tiered = dataclasses.replace(params, store_pages=NP, gather_vectors=True)
    with pytest.raises(NotImplementedError, match="gather_vectors"):
        stream_search(consts, geom, tiered, entry, queries, num_slots=2,
                      pagestore=_store(ds, NP), **CPU)


# ---------------------------------------------------------------------------
# Epoch swap and capture reuse
# ---------------------------------------------------------------------------
def test_swap_epoch_keeps_residency_and_restages_frames(ds, ref_engine):
    """swap_epoch with a store of the same shape keeps ttab / frame_page
    and rewrites every resident frame from the new cold tier, in place
    (the frame buffers keep their addresses), drops the staged payload
    and its reservations, as the reference's; a changed shape raises."""
    NP = _num_pages(ds)
    consts = ds[1][0]
    ps = _store(ds, NP // 2, prefetch_pages=2)
    jps = _jstore(ref_engine, NP // 2, prefetch_pages=2)
    score = np.zeros((ps.S, NP))
    score[:, NP - 2:] = 5.0
    S = ps.S
    miss = np.zeros((S, NP), bool)
    miss[1, NP // 2 + 1] = True
    for store in (ps, jps):
        store._predict = lambda *a: score
        store.boundary(np.zeros_like(miss), miss, *_no_cands(S, 1))
    assert ps.reserved.any() and ps._staged is not None
    ptrs = {k: v.data_ptr() for k, v in ps.device_view().items()}
    ttab, frame_page = ps.ttab.copy(), ps.frame_page.copy()
    new = dict(consts, db=consts["db"] + 1.0, vnorm=consts["vnorm"] * 2.0)
    view = ps.swap_epoch(new)
    jnew = dict(ref_engine[0], db=ref_engine[0]["db"] + 1.0,
                vnorm=ref_engine[0]["vnorm"] * 2.0)
    jps.swap_epoch(jnew)
    assert {k: v.data_ptr() for k, v in view.items()} == ptrs
    np.testing.assert_array_equal(ps.ttab, ttab)
    np.testing.assert_array_equal(ps.frame_page, frame_page)
    assert not ps.reserved.any() and ps._staged is None
    assert torch.equal(ps.cold_db, new["db"])
    _check_frames(ps)
    np.testing.assert_array_equal(ps.frames.numpy(), np.asarray(jps.frames))
    np.testing.assert_array_equal(ps.vnf.numpy(), np.asarray(jps.vnf))
    # the next boundary commits nothing stale
    ps.boundary(np.zeros_like(miss), np.zeros_like(miss), *_no_cands(S, 1))
    _check_frames(ps)
    with pytest.raises(ValueError, match="epoch swap changed the store"):
        ps.swap_epoch(dict(new, db=new["db"][:, :-1]))


def test_half_resident_wrapping_ring_session_captures_once(ds):
    """The reference's compile-once claim for the tiered store
    (tests/test_analysis.py), as capture-once: a half-resident session
    with a wrapping admission ring and in-device admission builds one
    chunk-program entry (the warmup's), its consts keep their addresses
    across every boundary, one read per chunk, and the results equal
    the untiered, unringed session's."""
    queries, (consts, geom, entry) = ds
    NP = _num_pages(ds)
    ps = _store(ds, NP // 2)
    nq = queries.shape[0]
    arrivals = np.arange(nq, dtype=np.int64) * 2   # forces ring restaging
    ptrs = {k: v.data_ptr() for k, v in ps.device_view().items()}
    seen = []
    boundary = ps.boundary

    def watched(*a):
        out = boundary(*a)
        seen.append({k: v.data_ptr() for k, v in out.items()})
        return out

    ps.boundary = watched
    CACHE.reset_stats()
    ids, dists, st = _run(ds, pagestore=ps, arrivals=arrivals,
                          injit_admit=True, ring_capacity=6)
    assert CACHE.stats.captures <= 1
    assert len(seen) == st.host_dispatches > 1
    assert all(p == ptrs for p in seen)
    assert st.host_syncs == st.host_dispatches
    assert st.stalls > 0 and ps.counters()["demand_fetches"] > 0
    assert len(st.results) == nq
    ref_i, ref_d, _ = _run(ds, arrivals=arrivals, injit_admit=True)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
