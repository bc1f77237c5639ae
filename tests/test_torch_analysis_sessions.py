"""``CaptureGuard`` (repro_torch/analysis/capture_guard.py) over whole
serving sessions on the CPU: one chunk-program build covers a session
with a wrapping admission ring and a half-resident page store, a
staggered-arrival session, and live sessions through epoch swaps, flat
and tiered. The twins of the reference's compile-once tests
(tests/test_analysis.py, tests/test_scheduler.py, tests/test_live.py),
which count XLA compiles; split from tests/test_torch_analysis.py to
keep each file well inside its time."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.analysis.capture_guard import CaptureGuard

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _guard_dataset(n=512, d=24, nq=16, S=2, page=8, seed=3, pref=2):
    """Unique dims, so no other test pre-built these programs' entries."""
    from repro_torch.core.graph import build_vamana
    from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, alpha=1.2, seed=seed)
    geo = Geometry(num_shards=S, page_size=page, pages_per_block=2, dim=d)
    index = LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                  pref_width=pref)
    return db, queries, pack_index(index, max_degree=8)


def test_one_capture_covers_ring_wrapping_partial_residency_session():
    """A multi-chunk session with ring-window restaging AND a
    half-resident tiered page store (its device view refreshed at every
    boundary) dispatches against exactly one engine_run_chunk_admit
    entry, and returns the untiered, unringed session's results bit
    for bit."""
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import stream_search

    db, queries, packed = _guard_dataset()
    consts, geom, entry = pack_for_engine(packed, host_pages=True, **CPU)
    sp = SearchParams(L=8, W=1, k=5)
    params = EngineParams.lossless(sp, 2, geom.max_degree, spec_width=2)
    NP = consts["db"].shape[1]
    params = dataclasses.replace(params, store_pages=NP)
    ps = PageStore(consts, geom, NP // 2, w_select=1)
    nq = queries.shape[0]
    arrivals = np.arange(nq, dtype=np.int64) * 2   # forces ring re-staging
    ring = 6                                       # < nq: window must wrap

    with CaptureGuard() as cg:
        ids, dists, stats = stream_search(
            consts, geom, params, entry, queries, num_slots=2,
            round_chunk=2, arrivals=arrivals, injit_admit=True,
            ring_capacity=ring, pagestore=ps, **CPU)

    n = cg.count("engine_run_chunk_admit")
    assert n == 1, f"expected exactly one build, saw {n}: {cg.names}"
    # the session really exercised the claim: multiple dispatches, a
    # wrapped ring and partial residency with real demand fetches
    assert stats.host_dispatches > 1
    assert stats.stalls > 0 and ps.counters()["demand_fetches"] > 0
    assert len(stats.results) == nq
    ref_c, _, _ = pack_for_engine(packed, **CPU)
    ref_i, ref_d, _ = stream_search(
        ref_c, geom, dataclasses.replace(params, store_pages=0), entry,
        queries, num_slots=2, round_chunk=2, arrivals=arrivals,
        injit_admit=True, **CPU)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)


def test_session_captures_stepper_exactly_once():
    """Every retire/refill/admit boundary re-dispatches the same chunk
    program: a staggered-arrival in-device-admission session builds
    exactly one engine_run_chunk_admit entry, however many chunks the
    host loop runs (tests/test_scheduler.py's compile-once twin)."""
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import stream_search

    _, queries, packed = _guard_dataset(n=768, d=28, nq=20, page=16, seed=5,
                                        pref=4)
    consts, geom, entry = pack_for_engine(packed, **CPU)
    params = EngineParams.lossless(SearchParams(L=12, W=1, k=8), 2,
                                   geom.max_degree, spec_width=4)
    arrivals = np.random.default_rng(7).integers(0, 12, queries.shape[0])
    with CaptureGuard() as cg:
        _, _, st = stream_search(consts, geom, params, entry, queries,
                                 num_slots=2, arrivals=arrivals,
                                 round_chunk=4, injit_admit=True, **CPU)
    n = cg.count("engine_run_chunk_admit")
    assert n == 1, f"expected exactly one build, saw {n}: {cg.names}"
    assert st.host_dispatches > 1
    assert st.total_rounds > 4
    assert len(st.results) == queries.shape[0]


LIVE = dict(N0=256, D=20, NQ=16, shards=2, page=8, r=8)


@pytest.fixture(scope="module")
def live_data():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((LIVE["N0"], LIVE["D"])).astype(np.float32)
    queries = rng.standard_normal((LIVE["NQ"], LIVE["D"])).astype(np.float32)
    return db, queries


def _live_session(db, queries, seed: int, tiered: bool):
    """tests/test_live.py's compile-once sessions: inserts, deletes and
    epoch swaps (refresh every 6 rounds) through one session."""
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.live import build_live_index, mutation_schedule
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import stream_search

    sched = mutation_schedule(0.2, 0.05, 80, LIVE["D"], seed=seed, ref=db)
    live = build_live_index(db, shards=LIVE["shards"],
                            page_size=LIVE["page"], r=LIVE["r"],
                            delta_cap=4, seed=3, refresh_every=6,
                            schedule=sched)
    lc, lg, le = pack_for_engine(live.ep.packed, host_pages=tiered, **CPU)
    params = dataclasses.replace(EngineParams.lossless(
        SearchParams(L=16, W=1, k=8), 2, LIVE["r"]), delta_cap=4)
    ps = None
    if tiered:
        NP = lc["db"].shape[1]
        params = dataclasses.replace(params, store_pages=NP)
        ps = PageStore(lc, lg, NP // 2, w_select=1)
    arrivals = np.sort(np.random.default_rng(seed).integers(
        0, 80, size=LIVE["NQ"]))
    with CaptureGuard() as cg:
        _, _, st = stream_search(lc, lg, params, le, queries, num_slots=2,
                                 arrivals=arrivals, pagestore=ps, live=live,
                                 **CPU)
    return cg, st, live


def test_session_with_swaps_captures_stepper_once(live_data):
    """Inserts, deletes and >= 2 epoch swaps in one session: one build.
    Every mutable piece (delta segment, tombstones, main consts, entry)
    is a content-only update at fixed shape and address."""
    cg, st, live = _live_session(*live_data, seed=11, tiered=False)
    assert st.epoch_swaps >= 2
    assert live.inserts > 0 and live.deletes > 0
    assert cg.count("engine_run_chunk_admit") == 1, cg.names


def test_tiered_live_session_captures_once(live_data):
    """The same gate on the half-resident tiered leg: the swap restages
    resident frames in place through the page store's install."""
    cg, st, _ = _live_session(*live_data, seed=13, tiered=True)
    assert st.epoch_swaps >= 2
    assert cg.count("engine_run_chunk_admit") == 1, cg.names
    assert len(st.results) == LIVE["NQ"]
