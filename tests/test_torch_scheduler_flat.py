"""The reference's card-free flat-path scheduler tests
(tests/test_scheduler.py) on the port, on the same integer index:
streaming == one-shot ``search_sim`` over arrivals, slots, chunks and
admission paths; chunked == per-round; slot reuse; the speculation
controller; the serving metrics and the idle clock; deadlines; the
admission ring and routed admission against the reference's sessions;
what is not ported raises."""
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
from repro.core.ref_search import SearchParams as JSearchParams
from repro.core.scheduler import StreamScheduler as JStreamScheduler
from repro.core.scheduler import stream_search as j_stream_search
from repro_torch.core.engine import (EngineParams, engine_admit,
                                     engine_init, engine_round,
                                     make_stepper, pack_for_engine,
                                     search_sim)
from repro_torch.core.graph import (brute_force_topk, build_vamana,
                                    recall_at_k)
from repro_torch.core.luncsr import LUNCSR, Geometry, PackedIndex, pack_index
from repro_torch.core.metrics import latency_percentiles, stream_summary
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import (QueryResult, SpecController,
                                        StreamScheduler, StreamStats,
                                        poisson_arrivals, stream_search)
from repro_torch.utils import INVALID, bloom_pack

CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small torch ops on integer data: one
    intra-op thread each, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def as_port_index(packed) -> PackedIndex:
    g = packed.geometry
    return PackedIndex.from_arrays(
        db=packed.db, vnorm=packed.vnorm, adj=packed.adj,
        adj_owner=packed.adj_owner, pref=packed.pref,
        pref_owner=packed.pref_owner, blk_perm=packed.blk_perm,
        entry=packed.entry, n=packed.n, max_degree=packed.max_degree,
        num_shards=g.num_shards, page_size=g.page_size,
        pages_per_block=g.pages_per_block, dim=g.dim, stripe=g.stripe)


def _dataset(n=1024, d=32, nq=32, S=4, page=32, seed=0, pref_width=8):
    """tests/test_scheduler.py's integer index, built by the reference."""
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    adj, medoid = j_vamana(db, r=12, alpha=1.2, seed=seed)
    geo = JGeometry(num_shards=S, page_size=page, pages_per_block=2, dim=d)
    packed = j_pack_index(JLUNCSR.from_adjacency(
        db, adj, geo, entry=medoid, pref_width=pref_width), max_degree=12)
    return db, queries, packed


@pytest.fixture(scope="module")
def built():
    return _dataset()


@pytest.fixture(scope="module")
def ds(built):
    db, queries, packed = built
    return db, queries, pack_for_engine(as_port_index(packed), **CPU)


@pytest.fixture(scope="module")
def ref_engine(built):
    """The same index in the reference package (jnp mode)."""
    return j_pack_for_engine(built[2])


def _records(st):
    """Every QueryResult field but the wall time, by qid."""
    return {r.qid: (tuple(r.ids), tuple(r.dists), r.arrival_round,
                    r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.truncated, r.stall_rounds)
            for r in st.results}


def _oneshot(port, queries, sp, spec=0, mode="ref"):
    """Per-query results from the port's frozen-batch driver."""
    consts, geom, entry = port
    S, nq = geom.num_shards, queries.shape[0]
    params = EngineParams.lossless(sp, nq // S, geom.max_degree,
                                   spec_width=spec, kernel_mode=mode)
    i, d, _ = search_sim(consts, queries.reshape(S, nq // S, -1), *entry,
                         params, geom, **CPU)
    return i.reshape(nq, -1).numpy(), d.reshape(nq, -1).numpy()


def _lossless(sp, slots, geom, **kw):
    return EngineParams.lossless(sp, slots, geom.max_degree,
                                 kernel_mode="ref", **kw)


# ---------------------------------------------------------------------------
# Streaming == the port's one-shot driver, any arrivals/slots/chunks,
# host-paced or in-device admission (tests/test_scheduler.py's flat path)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("injit", [False, True])
@pytest.mark.parametrize("slots,spec,chunk",
                         [(1, 0, 1), (3, 0, 3), (8, 4, 8), (3, 4, 8)])
def test_stream_matches_oneshot_bitexact(ds, slots, spec, chunk, injit):
    _, queries, port = ds
    consts, geom, entry = port
    sp = SearchParams(L=16, W=1, k=10)
    ref_i, ref_d = _oneshot(port, queries, sp, spec)
    params = _lossless(sp, slots, geom, spec_width=spec)
    arrivals = np.random.default_rng(slots + spec).integers(0, 20,
                                                            len(queries))
    ids, dists, st = stream_search(consts, geom, params, entry, queries,
                                   num_slots=slots, arrivals=arrivals,
                                   round_chunk=chunk, injit_admit=injit,
                                   **CPU)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert len(st.results) == len(queries)


@pytest.mark.parametrize("seed", range(5))
def test_stream_arrival_orders_match_oneshot(ds, seed):
    """Seeded draws of the reference's property test: arrival order,
    slot count, arrival spacing, round chunk and admission path leave
    every per-query result bit-identical to one-shot search_sim."""
    _, queries, port = ds
    consts, geom, entry = port
    sp = SearchParams(L=8, W=1, k=5)
    nq = 8
    q = queries[:nq]
    ref_i, ref_d = _oneshot(port, q, sp)
    rng = np.random.default_rng(seed)
    for _ in range(2):
        slots = int(rng.integers(1, 5))
        order = rng.permutation(nq)
        arrivals = np.zeros(nq, np.int64)
        arrivals[order] = np.cumsum(rng.integers(0, 13, nq))
        params = _lossless(sp, slots, geom)
        ids, dists, _ = stream_search(
            consts, geom, params, entry, q, num_slots=slots,
            arrivals=arrivals, round_chunk=int(rng.choice([1, 3, 8])),
            injit_admit=bool(rng.integers(0, 2)), **CPU)
        np.testing.assert_array_equal(ids, ref_i)
        np.testing.assert_array_equal(dists, ref_d)


# ---------------------------------------------------------------------------
# Round chunks: same schedule, same accounting, fewer dispatches
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("injit", [False, True])
@pytest.mark.parametrize("dynamic", [False, True])
def test_chunked_matches_per_round_exact(ds, dynamic, injit):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 3, geom, spec_width=8)
    arrivals = np.random.default_rng(3).integers(0, 15, len(queries))

    def run(chunk, inj=injit):
        return stream_search(consts, geom, params, entry, queries,
                             num_slots=3, arrivals=arrivals,
                             dynamic_spec=dynamic, round_chunk=chunk,
                             injit_admit=inj, **CPU)[2]

    base = run(1, inj=False)
    for chunk in (3, 8):
        st = run(chunk)
        assert _records(st) == _records(base)
        assert st.total_rounds == base.total_rounds
        assert st.occupancy_trace == base.occupancy_trace
        assert st.spec_trace == base.spec_trace
        assert st.host_dispatches < base.host_dispatches


def test_injit_admission_drops_dispatches(ds):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 3, geom, spec_width=8)
    arrivals = np.random.default_rng(3).integers(0, 15, len(queries))

    def run(inj):
        return stream_search(consts, geom, params, entry, queries,
                             num_slots=3, arrivals=arrivals, round_chunk=8,
                             injit_admit=inj, **CPU)[2]

    st_on, st_off = run(True), run(False)
    assert _records(st_on) == _records(st_off)
    assert st_on.total_rounds == st_off.total_rounds
    assert st_on.occupancy_trace == st_off.occupancy_trace
    assert st_on.host_dispatches < st_off.host_dispatches
    assert (st_on.total_rounds / st_on.host_dispatches
            > st_off.total_rounds / st_off.host_dispatches)
    # the port reads the loop condition once per round either way, so
    # fewer dispatches also means fewer syncs
    assert st_on.host_syncs < st_off.host_syncs


def test_chunked_frozen_matches_per_round(ds):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)

    def run(chunk):
        return stream_search(consts, geom, params, entry, queries[:16],
                             num_slots=2, refill=False, round_chunk=chunk,
                             **CPU)[2]

    base, chunked = run(1), run(8)
    assert _records(chunked) == _records(base)
    assert chunked.total_rounds == base.total_rounds
    assert chunked.occupancy_trace == base.occupancy_trace
    assert chunked.host_dispatches < base.host_dispatches


# ---------------------------------------------------------------------------
# Retire/refill slot reuse: stale state must be fully reset
# ---------------------------------------------------------------------------
def test_admit_resets_slot_state(ds):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    S = geom.num_shards
    qA = torch.as_tensor(np.tile(queries[0], (S, 2, 1)))
    qB = torch.as_tensor(np.tile(queries[1], (S, 2, 1)))
    state = engine_init(consts, qA, *entry, params, geom)
    for _ in range(5):   # pollute the pool with A's progress
        state = engine_round(consts, state, qA, 0, params, geom)
    assert int(state.n_dist.sum()) > 0
    readmit, qbuf = engine_admit(state, qA, torch.ones((S, 2), dtype=bool),
                                 qB, *entry, params, geom)
    fresh = engine_init(consts, qB, *entry, params, geom)
    for leaf_r, leaf_f, name in zip(readmit, fresh, state._fields):
        if name in ("items_recv", "pages_unique", "drops_b", "props_sent"):
            continue   # shard-cumulative counters survive by design
        if name == "bloom":
            leaf_r, leaf_f = bloom_pack(leaf_r), bloom_pack(leaf_f)
        assert torch.equal(leaf_r, leaf_f), name
    assert torch.equal(qbuf, qB)


def test_slot_reuse_end_to_end(ds):
    _, queries, port = ds
    consts, geom, entry = port
    sp = SearchParams(L=16, W=1, k=10)
    ref_i, ref_d = _oneshot(port, queries[:8], sp)
    ids, dists, st = stream_search(consts, geom, _lossless(sp, 1, geom),
                                   entry, queries[:8], num_slots=1, **CPU)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert len(st.results) > geom.num_shards   # rows were reused


# ---------------------------------------------------------------------------
# Scheduler behaviour: refill occupancy, frozen baseline, controller
# ---------------------------------------------------------------------------
def test_refill_beats_frozen_occupancy(ds):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    st_refill = stream_search(consts, geom, params, entry, queries,
                              num_slots=2, **CPU)[2]
    st_frozen = stream_search(consts, geom, params, entry, queries,
                              num_slots=2, refill=False, **CPU)[2]
    assert st_refill.occupancy > st_frozen.occupancy
    assert st_refill.total_rounds <= st_frozen.total_rounds


def test_dynamic_spec_reduces_pages_same_recall():
    """The clustered serving workload: the per-query controller reads no
    more pages than the static spec_max run, at recall within 2pt."""
    from repro_torch.data.vectors import VectorDataset

    vds = VectorDataset("sched-dyn", n=2048, dim=48, clusters=16, seed=0)
    db = vds.materialize()
    queries = vds.queries(48, seed=1)
    adj, medoid = build_vamana(db, r=16, seed=0)
    geo = Geometry(num_shards=4, page_size=64, pages_per_block=4, dim=48)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=8), max_degree=16)
    consts, geom, entry = pack_for_engine(packed, **CPU)
    params = _lossless(SearchParams(L=32, W=1, k=10), 4, geom, spec_width=8)
    ids_s, _, st_s = stream_search(consts, geom, params, entry, queries,
                                   num_slots=4, **CPU)
    ids_d, _, st_d = stream_search(consts, geom, params, entry, queries,
                                   num_slots=4, dynamic_spec=True, **CPU)
    assert st_d.pages_unique <= st_s.pages_unique
    true_i, _ = brute_force_topk(db, queries, 10)
    assert recall_at_k(ids_d, true_i) >= recall_at_k(ids_s, true_i) - 0.02
    assert min(st_d.spec_trace) < params.spec_width


def test_spec_controller_bounds():
    ctrl = SpecController(spec_max=8, W=1, max_degree=12)
    worked = np.ones((2, 3), bool)
    w = ctrl.update(np.full((2, 3), 20), worked)
    assert (w == 8).all()                    # fresh frontier: full width
    for _ in range(8):                       # acceptance collapses ...
        w = ctrl.update(np.zeros((2, 3)), worked)
        assert ((w >= 0) & (w <= 8)).all()
    assert (ctrl.spec_w == 0).all()          # ... width ramps to 0
    ctrl.reset_rows(np.asarray([[True, False, False],
                                [False, False, False]]))
    assert ctrl.spec_w[0, 0] == 8            # fresh query at full width
    assert ctrl.spec_w[1, 1] == 0


def test_spec_controller_normalizes_by_used_width():
    ctrl = SpecController(spec_max=8, W=2, max_degree=12)
    worked = np.ones((1, 1), bool)
    w = ctrl.update(np.full((1, 1), 2 * (12 + 8)), worked)
    assert w[0, 0] == 8 and ctrl._hit[0, 0] == pytest.approx(1.0)
    ctrl.update(np.zeros((1, 1)), worked)
    used = int(ctrl.spec_w[0, 0])
    assert used < 8
    before = ctrl._hit[0, 0]
    ctrl.update(np.full((1, 1), 2 * (12 + used)), worked)
    assert ctrl._hit[0, 0] == pytest.approx(0.5 * before + 0.5 * 1.0)


# ---------------------------------------------------------------------------
# Serving metrics: empty runs, warmup accounting, the idle clock
# ---------------------------------------------------------------------------
def test_stream_summary_empty_run(ds):
    assert latency_percentiles([]) == {"p50": 0.0, "p95": 0.0,
                                       "p99": 0.0, "mean": 0.0}
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    ids, dists, st = stream_search(
        consts, geom, params, entry,
        np.zeros((0, queries.shape[1]), np.float32), num_slots=2, **CPU)
    assert ids.shape == (0, 10) and dists.shape == (0, 10)
    summ = stream_summary(st)
    assert summ["queries"] == 0 and summ["sustained_qps"] == 0.0
    assert summ["dispatches_per_query"] == 0.0
    assert summ["latency_rounds"]["p99"] == 0.0
    assert summ["wall_latency_ms"]["p99"] == 0.0
    assert summ["host_syncs"] == 0 and summ["warmup_rounds"] == 0


def test_stream_wall_excludes_compile(ds):
    """The warmup chunk (kernel builds on a card) stays out of wall_s
    and the wall latencies; it is reported as compile_s and its rounds
    as warmup_rounds."""
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    st = stream_search(consts, geom, params, entry, queries[:8],
                       num_slots=2, round_chunk=4, **CPU)[2]
    assert st.compile_s > 0.0 and st.wall_s > 0.0
    assert st.warmup_rounds == 4          # one full chunk on live rows
    summ = stream_summary(st)
    assert summ["compile_s"] == round(st.compile_s, 3)
    assert summ["host_dispatches"] == st.host_dispatches > 0
    assert max(r.wall_latency_s for r in st.results) <= st.wall_s + 0.5


@pytest.mark.parametrize("injit,chunk", [(False, 1), (False, 8),
                                         (True, 1), (True, 8)])
def test_idle_rounds_stay_on_the_clock(ds, injit, chunk):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    nq = 16
    arrivals = np.concatenate([np.zeros(nq // 2, np.int64),
                               np.full(nq // 2, 500, np.int64)])
    st = stream_search(consts, geom, params, entry, queries[:nq],
                       num_slots=2, arrivals=arrivals, round_chunk=chunk,
                       injit_admit=injit, **CPU)[2]
    assert st.idle_rounds > 0
    clock = st.total_rounds + st.idle_rounds
    assert clock >= 500
    busy_only = sum(st.occupancy_trace) / max(
        len(st.occupancy_trace) * geom.num_shards * 2, 1)
    assert st.occupancy < busy_only
    assert st.occupancy == pytest.approx(
        sum(st.occupancy_trace) / (clock * geom.num_shards * 2))
    summ = stream_summary(st)
    assert summ["idle_rounds"] == st.idle_rounds
    assert summ["queries_per_round"] == round(nq / clock, 3)
    by_qid = st.by_qid()
    assert all(by_qid[q].admit_round >= 500 for q in range(nq // 2, nq))
    base = stream_search(consts, geom, params, entry, queries[:nq],
                         num_slots=2, arrivals=arrivals, round_chunk=1,
                         injit_admit=False, **CPU)[2]
    assert st.idle_rounds == base.idle_rounds
    assert st.total_rounds == base.total_rounds


def test_stream_summary_covers_stats_fields(ds):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    st = stream_search(consts, geom, params, entry, queries[:8],
                       num_slots=2, **CPU)[2]
    summ = stream_summary(st)
    for f in dataclasses.fields(StreamStats):
        if f.name not in {"results", "occupancy_trace", "spec_trace"}:
            assert f.name in summ, f"stream_summary dropped {f.name}"
    assert summ["props_sent"] == st.props_sent > 0
    assert summ["shed"] == 0 and summ["truncated"] == 0
    assert summ["quarantined"] == 0 and summ["legs_fused_hist"] == []
    assert summ["goodput"] == 1.0
    assert summ["stalls"] == 0 and summ["stall_rounds_per_query"] == 0.0
    assert summ["prefetch_hits"] == 0 and summ["prefetch_issued"] == 0
    assert summ["prefetch_hit_rate"] == 0.0
    assert summ["resident_fraction"] == 1.0
    assert summ["delta_hits"] == 0 and summ["tombstoned"] == 0
    assert summ["epoch_swaps"] == 0 and summ["swap_stall_rounds"] == 0


def test_goodput_counts_each_query_once():
    def qr(qid, truncated):
        return QueryResult(
            qid=qid, ids=np.zeros(4, np.int32),
            dists=np.zeros(4, np.float32), arrival_round=0,
            admit_round=0, retire_round=5, service_rounds=5, n_dist=10,
            wall_latency_s=0.1, truncated=truncated)

    st = StreamStats(
        results=[qr(0, False), qr(1, True), qr(2, False), qr(3, False)],
        total_rounds=10, occupancy=0.5, occupancy_trace=[],
        pages_unique=1, items_recv=1, props_sent=1, drops_b=0,
        spec_trace=[], wall_s=1.0, shed=2, truncated=1, quarantined=2)
    summ = stream_summary(st)
    assert summ["goodput"] == round(3 / 6, 4)
    st2 = dataclasses.replace(st, quarantined=10**6)
    assert stream_summary(st2)["goodput"] == summ["goodput"]


def test_poisson_arrivals_rounds_half_up():
    rate, n, seed = 0.25, 4096, 7
    arr = poisson_arrivals(rate, n, seed=seed)
    assert arr.dtype == np.int64 and (np.diff(arr) >= 0).all()
    exact = np.cumsum(
        np.random.default_rng(seed).exponential(1.0 / rate, n))
    assert abs((arr - exact).mean()) < 0.05
    assert abs(n / arr[-1] - rate) / rate < 0.02
    assert poisson_arrivals(0.0, 5).tolist() == [0] * 5


def test_stats_shapes_unified(ds):
    _, queries, (consts, geom, entry) = ds
    S = geom.num_shards
    params = _lossless(SearchParams(L=16, W=1, k=10), len(queries) // S,
                       geom)
    _, _, stats = search_sim(consts, queries.reshape(S, -1, queries.shape[1]),
                             *entry, params, geom, **CPU)
    assert tuple(stats["total_rounds"].shape) == (S,)
    assert (stats["total_rounds"] == stats["total_rounds"][0]).all()


def test_engine_retire_matches_search_sim_finalize(ds):
    _, queries, (consts, geom, entry) = ds
    S, nq = geom.num_shards, len(queries)
    params = _lossless(SearchParams(L=16, W=1, k=10), nq // S, geom)
    qsh = torch.as_tensor(queries.reshape(S, nq // S, -1))
    ref_i, ref_d, ref_stats = search_sim(consts, qsh, *entry, params, geom,
                                         **CPU)
    stepper = make_stepper(params, geom)
    state = stepper.init(consts, qsh, *entry)
    t = 0
    while bool((~state.done).any()) and t < params.search.rounds_cap:
        state = stepper.round(consts, state, qsh, params.spec_width)
        t += 1
    out_i, out_d, stats = stepper.retire(state)
    assert torch.equal(out_i, ref_i) and torch.equal(out_d, ref_d)
    assert torch.equal(stats["rounds"], ref_stats["rounds"])
    assert t == int(ref_stats["total_rounds"][0])


@pytest.mark.parametrize("mode", ["torch", "ref"])
def test_stream_kernel_modes_bitexact(ds, mode):
    """The scheduler composes with the kernel backend: each mode streams
    bit-identically to the other mode's one-shot driver."""
    _, queries, port = ds
    consts, geom, entry = port
    sp = SearchParams(L=16, W=1, k=10)
    ref_i, ref_d = _oneshot(port, queries[:16], sp,
                            mode="ref" if mode == "torch" else "torch")
    params = EngineParams.lossless(sp, 4, geom.max_degree, kernel_mode=mode)
    ids, dists, _ = stream_search(consts, geom, params, entry, queries[:16],
                                  num_slots=4, **CPU)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)


# ---------------------------------------------------------------------------
# Deadlines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("injit", [False, True])
def test_deadline_force_retires(ds, injit):
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom,
                       deadline_rounds=3)
    _, _, st = stream_search(consts, geom, params, entry, queries[:16],
                             num_slots=2, round_chunk=8, injit_admit=injit,
                             **CPU)
    assert len(st.results) == 16 and st.truncated == 16
    for r in st.results:
        assert r.truncated
        assert r.retire_round - r.admit_round == 3 == r.service_rounds
        assert (r.ids != INVALID).any()
        assert np.isfinite(r.dists[r.ids != INVALID]).all()


@pytest.mark.parametrize("injit", [False, True])
def test_deadline_off_bit_identity(ds, injit):
    _, queries, (consts, geom, entry) = ds
    sp = SearchParams(L=16, W=1, k=10)
    arrivals = np.random.default_rng(5).integers(0, 12, 16)

    def run(params):
        return stream_search(consts, geom, params, entry, queries[:16],
                             num_slots=3, arrivals=arrivals, round_chunk=8,
                             injit_admit=injit, **CPU)[2]

    base = run(_lossless(sp, 3, geom))
    huge = run(_lossless(sp, 3, geom, deadline_rounds=10**6))
    assert _records(huge) == _records(base)
    assert huge.total_rounds == base.total_rounds
    assert huge.occupancy_trace == base.occupancy_trace
    assert huge.truncated == 0


# ---------------------------------------------------------------------------
# The bounded admission ring (tests/test_scheduler.py's ring tests)
# ---------------------------------------------------------------------------
def _ref_lossless(sp, slots, geom, **kw):
    return JEngineParams.lossless(JSearchParams(L=sp.L, W=sp.W, k=sp.k),
                                  slots, geom.max_degree, kernel_mode="jnp",
                                  **kw)


def test_ring_full_capacity_bit_identity(ds):
    """A ring holding the whole stream reproduces the unbounded staging
    path exactly: schedule, traces, accounting."""
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 3, geom)
    arrivals = np.random.default_rng(6).integers(0, 15, len(queries))

    def run(ring):
        return stream_search(consts, geom, params, entry, queries,
                             num_slots=3, arrivals=arrivals, round_chunk=8,
                             ring_capacity=ring, **CPU)[2]

    base, ringed = run(0), run(len(queries))
    assert _records(ringed) == _records(base)
    assert ringed.total_rounds == base.total_rounds
    assert ringed.occupancy_trace == base.occupancy_trace
    assert ringed.shed == 0


@pytest.mark.parametrize("ring", [1, 2, 5, 12, 16])
def test_ring_block_any_capacity(ds, ref_engine, ring):
    """Under the block policy any ring capacity >= 1 serves every query
    with the unbounded stream's per-query results (admission order is
    arrival order either way; the window only bounds device memory),
    and with the reference's ring session's records bit for bit."""
    _, queries, (consts, geom, entry) = ds
    sp = SearchParams(L=8, W=1, k=5)
    q = queries[:12]
    params = _lossless(sp, 2, geom)
    arrivals = np.random.default_rng(9).integers(0, 8, len(q))
    kw = dict(num_slots=2, arrivals=arrivals, round_chunk=8)
    ref_i, ref_d, _ = stream_search(consts, geom, params, entry, q, **kw,
                                    **CPU)
    ids, dists, st = stream_search(consts, geom, params, entry, q, **kw,
                                   ring_capacity=ring, overload="block",
                                   **CPU)
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert st.shed == 0 and len(st.results) == len(q)
    jc, jg, je = ref_engine
    _, _, jst = j_stream_search(jc, jg, _ref_lossless(sp, 2, geom), je, q,
                                **kw, ring_capacity=ring, overload="block")
    assert _records(st) == _records(jst)
    assert st.occupancy_trace == jst.occupancy_trace


def test_ring_shed_overload(ds, ref_engine):
    """Shed policy under a burst far beyond ring capacity: overflow
    queries are rejected and counted, every admitted query retires with
    exact results, shed + retired covers the stream, shed queries keep
    INVALID rows; the same queries are shed as by the reference."""
    _, queries, (consts, geom, entry) = ds
    sp = SearchParams(L=16, W=1, k=10)
    params = _lossless(sp, 1, geom)
    nq = len(queries)
    kw = dict(num_slots=1, arrivals=np.zeros(nq, np.int64), round_chunk=8)
    ids, dists, st = stream_search(consts, geom, params, entry, queries,
                                   **kw, ring_capacity=4, overload="shed",
                                   **CPU)
    assert st.shed > 0
    assert st.shed + len(st.results) == nq
    served = {r.qid for r in st.results}
    ref_i, _, _ = stream_search(consts, geom, params, entry, queries, **kw,
                                **CPU)
    for r in st.results:
        np.testing.assert_array_equal(r.ids, ref_i[r.qid])
    for qid in range(nq):
        if qid not in served:
            assert (ids[qid] == INVALID).all()
    jc, jg, je = ref_engine
    _, _, jst = j_stream_search(jc, jg, _ref_lossless(sp, 1, geom), je,
                                queries, **kw, ring_capacity=4,
                                overload="shed")
    assert st.shed == jst.shed and _records(st) == _records(jst)


def test_ring_validation(ds):
    """Ring knobs are validated at construction: bad policy names, the
    host-paced path and routed serving are rejected."""
    _, _, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    with pytest.raises(ValueError, match="overload"):
        StreamScheduler(consts, geom, params, entry, num_slots=2,
                        overload="panic", **CPU)
    with pytest.raises(ValueError, match="in-jit"):
        StreamScheduler(consts, geom, params, entry, num_slots=2,
                        injit_admit=False, ring_capacity=4, **CPU)
    with pytest.raises(ValueError, match="routed"):
        StreamScheduler(consts, geom, params, entry, num_slots=2,
                        routed=True, ring_capacity=4, **CPU)
    with pytest.raises(ValueError, match="refill"):
        StreamScheduler(consts, geom, params, entry, num_slots=2,
                        routed=True, refill=False, **CPU)


# ---------------------------------------------------------------------------
# Routed admission: per-shard queues on the flat index
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("injit", [False, True])
def test_routed_admission_matches_reference(ds, ref_engine, injit):
    """``run(target_shards=...)``: each row sits only in its target
    shard's slots and each shard drains its own queue (host-paced or
    staged per shard on the device); every record equals the
    reference's routed session, and per-query ids the flat stream's."""
    _, queries, (consts, geom, entry) = ds
    sp = SearchParams(L=16, W=1, k=10)
    params = _lossless(sp, 2, geom)
    rng = np.random.default_rng(4)
    arrivals = rng.integers(0, 20, len(queries))
    tgt = rng.integers(0, geom.num_shards, len(queries)).astype(np.int32)
    sched = StreamScheduler(consts, geom, params, entry, 2, round_chunk=8,
                            injit_admit=injit, routed=True, **CPU)
    st = sched.run(queries, arrivals, target_shards=tgt)
    jc, jg, je = ref_engine
    jsched = JStreamScheduler(jc, jg, _ref_lossless(sp, 2, geom), je, 2,
                              round_chunk=8, injit_admit=injit, routed=True)
    jst = jsched.run(queries, arrivals, target_shards=tgt)
    assert _records(st) == _records(jst)
    assert st.occupancy_trace == jst.occupancy_trace
    assert st.items_by_shard == jst.items_by_shard
    flat_i, _, _ = stream_search(consts, geom, params, entry, queries,
                                 num_slots=2, arrivals=arrivals,
                                 round_chunk=8, **CPU)
    for r in st.results:
        np.testing.assert_array_equal(r.ids, flat_i[r.qid])
    with pytest.raises(ValueError, match="routed=True"):
        StreamScheduler(consts, geom, params, entry, 2, **CPU).run(
            queries[:4], target_shards=tgt[:4])


# ---------------------------------------------------------------------------
# What is not ported raises, naming its ROADMAP item; the device rule
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("injit", [False, True])
def test_full_residency_store_equals_untiered(ds, injit):
    """The tiered page store (core/pagestore.py) at full residency is the
    identity configuration: every record equals the untiered stream's,
    in both admission paths (tests/test_torch_pagestore.py holds partial
    residency against the reference)."""
    from repro_torch.core.pagestore import PageStore
    _, queries, (consts, geom, entry) = ds
    sp = SearchParams(L=16, W=1, k=10)
    arrivals = np.random.default_rng(2).integers(0, 20, len(queries))
    kw = dict(num_slots=3, arrivals=arrivals, round_chunk=4,
              injit_admit=injit, **CPU)
    _, _, want = stream_search(consts, geom, _lossless(sp, 3, geom), entry,
                               queries, **kw)
    NP = consts["db"].shape[1]
    ps = PageStore(consts, geom, NP, w_select=1)
    _, _, st = stream_search(consts, geom,
                             _lossless(sp, 3, geom, store_pages=NP), entry,
                             queries, pagestore=ps, **kw)
    assert _records(st) == _records(want)
    assert st.stalls == 0 and ps.counters()["page_misses"] == 0
    assert st.host_syncs == st.host_dispatches == want.host_dispatches


@pytest.mark.parametrize("kw,item", [(dict(live=object()), 12)])
def test_unported_options_raise(ds, kw, item):
    """The live index (item 12) refuses a pool built without a delta
    segment, as the reference does (multi-device serving, item 13, is
    ported: tests/test_torch_mesh.py)."""
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    with pytest.raises(ValueError, match="delta_cap > 0"):
        StreamScheduler(consts, geom, params, entry, 2, **kw, **CPU)


def test_stream_search_without_device_cpu_raises_when_no_card(ds):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    _, queries, (consts, geom, entry) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 2, geom)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_search(consts, geom, params, entry, queries, num_slots=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamScheduler(consts, geom, params, entry, 2)
