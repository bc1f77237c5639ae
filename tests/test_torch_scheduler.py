"""The port's streaming scheduler vs the reference's (jnp mode) on one
integer-valued index, bit for bit: ids, dists, every per-query record
but its wall time, the round schedule, the occupancy and speculation
traces, dispatches and idle rounds, over slot counts, speculation,
round chunks, both admission paths, refill and frozen pools, dynamic
speculation and deadlines; the serving summary, the controller's host
mirror and the arrival clock. The reference's flat-path scheduler tests
run on the port in tests/test_torch_scheduler_flat.py."""
import numpy as np
import pytest
import torch

from repro.core import engine as J
from repro.core import scheduler as JS
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.metrics import stream_summary as j_stream_summary
from repro.core.ref_search import SearchParams as JSP
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.metrics import stream_summary
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import (SpecController, poisson_arrivals,
                                        stream_search)

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
def ds():
    db, queries, packed = _dataset()
    return (db, queries, pack_for_engine(as_port_index(packed), **CPU),
            J.pack_for_engine(packed))


def _records(st):
    """Every QueryResult field but the wall time, by qid."""
    return {r.qid: (tuple(r.ids), tuple(r.dists), r.arrival_round,
                    r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.truncated, r.stall_rounds)
            for r in st.results}


def _lossless(sp, slots, geom, **kw):
    return EngineParams.lossless(sp, slots, geom.max_degree,
                                 kernel_mode="ref", **kw)


# ---------------------------------------------------------------------------
# Port == reference, bit for bit
# ---------------------------------------------------------------------------
PARITY = [(slots, spec, chunk, injit, refill, dynamic, deadline)
          for slots, spec, chunk in ((1, 0, 1), (3, 0, 3), (8, 4, 8),
                                     (3, 4, 8))
          for injit in (False, True) for refill in (True, False)
          for dynamic in ((False, True) if spec else (False,))
          for deadline in (0, 5)]


@pytest.mark.parametrize(
    "slots,spec,chunk,injit,refill,dynamic,deadline", PARITY)
def test_stream_search_matches_reference(ds, slots, spec, chunk, injit,
                                         refill, dynamic, deadline):
    _, queries, port, (jc, jg, je) = ds
    consts, geom, entry = port
    sp = dict(L=16, W=1, k=10)
    params = _lossless(SearchParams(**sp), slots, geom, spec_width=spec,
                       deadline_rounds=deadline)
    jparams = J.EngineParams.lossless(JSP(**sp), slots, jg.max_degree,
                                      spec_width=spec,
                                      deadline_rounds=deadline)
    arrivals = np.random.default_rng(slots + spec).integers(0, 20,
                                                            len(queries))
    kw = dict(num_slots=slots, arrivals=arrivals, round_chunk=chunk,
              injit_admit=injit, refill=refill, dynamic_spec=dynamic)
    ids, dists, st = stream_search(consts, geom, params, entry, queries,
                                   **kw, **CPU)
    want_i, want_d, want = JS.stream_search(jc, jg, jparams, je, queries,
                                            **kw)
    np.testing.assert_array_equal(ids, want_i)
    np.testing.assert_array_equal(dists, want_d)
    assert _records(st) == _records(want)
    assert [r.qid for r in st.results] == [r.qid for r in want.results]
    for key in ("total_rounds", "occupancy", "occupancy_trace",
                "spec_trace", "host_dispatches", "idle_rounds",
                "injit_admit", "pages_unique", "items_recv", "props_sent",
                "drops_b", "items_by_shard", "truncated", "stalls"):
        assert getattr(st, key) == getattr(want, key), key
    # one read per chunk, at its boundary: the reference's host blocks
    assert st.host_syncs == st.host_dispatches
    assert st.truncated == (len(queries) if deadline else 0)


def test_stream_summary_matches_reference(ds):
    """Same keys as the reference's summary plus host_syncs and
    warmup_rounds; equal values but the wall and warmup clocks."""
    _, queries, (consts, geom, entry), (jc, jg, je) = ds
    params = _lossless(SearchParams(L=16, W=1, k=10), 3, geom, spec_width=4)
    jparams = J.EngineParams.lossless(JSP(L=16, W=1, k=10), 3,
                                      jg.max_degree, spec_width=4)
    kw = dict(num_slots=3, arrivals=poisson_arrivals(2.0, len(queries)),
              round_chunk=8, dynamic_spec=True)
    summ = stream_summary(stream_search(consts, geom, params, entry,
                                        queries, **kw, **CPU)[2])
    want = j_stream_summary(JS.stream_search(jc, jg, jparams, je, queries,
                                             **kw)[2])
    assert set(summ) == set(want) | {"host_syncs", "warmup_rounds"}
    clocks = {"wall_latency_ms", "sustained_qps", "wall_s", "compile_s"}
    for key in set(want) - clocks:
        assert summ[key] == want[key], key
    assert summ["host_syncs"] == summ["host_dispatches"] > 0


def test_poisson_arrivals_match_reference():
    for rate, n, seed in ((0.25, 512, 7), (8.0, 2048, 0), (0.0, 5, 1)):
        np.testing.assert_array_equal(poisson_arrivals(rate, n, seed),
                                      JS.poisson_arrivals(rate, n, seed))


@pytest.mark.parametrize("page_w", [0.0, 0.5])
def test_spec_controller_update_matches_reference(page_w):
    """The host mirror steps identically: widths and every EMA/peak
    array over ten rounds with admissions in between."""
    rng = np.random.default_rng(1)
    ports = SpecController(spec_max=8, W=1, max_degree=12, page_w=page_w)
    ref = JS.SpecController(spec_max=8, W=1, max_degree=12, page_w=page_w)
    for r in range(10):
        acc = rng.integers(0, 20, (4, 3))
        worked = rng.random((4, 3)) < 0.9
        pages = rng.integers(0, 9, 4)
        np.testing.assert_array_equal(ports.update(acc, worked, pages),
                                      ref.update(acc, worked, pages))
        for a in ("_hit", "_peak", "_phit", "_ppeak"):
            np.testing.assert_array_equal(getattr(ports, a),
                                          getattr(ref, a))
        if r % 3 == 2:
            mask = rng.random((4, 3)) < 0.4
            ports.reset_rows(mask)
            ref.reset_rows(mask)


