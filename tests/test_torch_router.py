"""Two-tier routing on the port against the reference (core/router.py):
twins of tests/test_router.py on its clustered fixture (N 512, D 16,
S 4, page 16, degree 8) — the routed build array for array, the router's
scores and routes, fusion bit for bit, R=S bit-identity with the
port's fan-out stream, the R<S recall floor, the idle shard, degraded
fusion — and whole routed sessions on an integer-valued routed index
against the reference's (jnp mode), every record but the clocks."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import router as J
from repro.core.backend import KernelBackend as JBackend
from repro.core.engine import EngineParams as JEngineParams
from repro.core.engine import pack_for_engine as j_pack_for_engine
from repro.core.metrics import stream_summary as j_stream_summary
from repro.core.ref_search import SearchParams as JSearchParams
from repro.core.scheduler import default_leg_L as j_default_leg_L
from repro.core.scheduler import routed_stream_search as j_routed
from repro.ft.inject import fault_plan as j_fault_plan
from repro_torch.core.backend import KernelBackend
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.luncsr import INVALID
from repro_torch.core.metrics import stream_summary
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.router import (BIG_DIST, _balanced_assign, _kmeans,
                                     build_routed_index, fuse_topk)
from repro_torch.core.scheduler import (default_leg_L, routed_stream_search,
                                        stream_search)
from repro_torch.ft.inject import fault_plan

N, D, S, PAGE, R_DEG = 512, 16, 4, 16, 8
CPU = dict(device="cpu")
PACKED = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
          "blk_perm")
# the serving report's wall clocks, and the backend's name
CLOCKS = {"kernel_mode", "wall_latency_ms", "sustained_qps", "wall_s",
          "compile_s"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores; at a fixed thread count torch's CPU results are
    deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rds():
    """tests/test_router.py's clustered data, built by both packages."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((S, D)).astype(np.float32) * 4
    db = np.concatenate([
        centers[i] + rng.standard_normal((N // S, D)).astype(np.float32)
        for i in range(S)])
    db = db[rng.permutation(N)]
    queries = db[rng.choice(N, 16, replace=False)] + \
        0.1 * rng.standard_normal((16, D)).astype(np.float32)
    kw = dict(shards=S, page_size=PAGE, r=R_DEG, centroids_per_shard=4,
              seed=0)
    ri = build_routed_index(db, kernel_mode="ref", **kw, **CPU)
    return db, queries.astype(np.float32), ri, J.build_routed_index(db, **kw)


@pytest.fixture(scope="module")
def engine(rds):
    return pack_for_engine(rds[2].packed, **CPU)


def _params(sp, slots, geom, **kw):
    return EngineParams.lossless(sp, slots, geom.max_degree,
                                 kernel_mode="ref", **kw)


def _recall(ids, gt):
    return np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist()))
                    / gt.shape[1] for i in range(len(ids))])


# ---------------------------------------------------------------------------
# build invariants, and the build equal to the reference's
# ---------------------------------------------------------------------------
def test_balanced_assign_exact_capacity():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((120, 8)).astype(np.float32)
    cent, _ = _kmeans(x, 3, seed=1)
    assign = _balanced_assign(x, cent, cap=40)
    assert np.all(np.bincount(assign, minlength=3) == 40)
    jcent, _ = J._kmeans(x, 3, seed=1)
    np.testing.assert_array_equal(cent, jcent)
    np.testing.assert_array_equal(assign, J._balanced_assign(x, jcent, 40))


def test_routed_build_invariants(rds, engine):
    """The port's routed build equals the reference's array for array:
    permutation, packed arrays, medoids, entry, sketches, shard
    entries; each medoid lies in its shard."""
    _, _, ri, jri = rds
    np.testing.assert_array_equal(ri.db, jri.db)
    for name in PACKED:
        np.testing.assert_array_equal(getattr(ri.packed, name),
                                      np.asarray(getattr(jri.packed, name)),
                                      err_msg=name)
    assert ri.packed.entry == jri.packed.entry
    assert ri.packed.geometry.stripe == "sequential"
    np.testing.assert_array_equal(ri.medoids, jri.medoids)
    np.testing.assert_array_equal(ri.router.centroids.numpy(),
                                  np.asarray(jri.router.centroids))
    np.testing.assert_array_equal(ri.router.cnorm.numpy(),
                                  np.asarray(jri.router.cnorm))
    for a, b in zip(ri.shard_entries, jri.shard_entries):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    m = N // S
    for s in range(S):
        assert s * m <= ri.medoids[s] < (s + 1) * m
    assert int(engine[2][2]) in set(int(x) for x in ri.medoids)
    ev, en, eid = ri.shard_entries
    assert ev.shape == (S, D) and en.shape == (S,) and eid.shape == (S,)


def test_router_routes_to_nearest_shard(rds):
    """Routes equal the reference's (a stable sort of the scores), the
    scores within 1e-6 of the norms' scale (q.q + c.c: the sums run in
    another order than XLA's), and the top-1 shard mostly holds the
    query's true nearest neighbour (clustered data)."""
    _, queries, ri, jri = rds
    score = ri.router.shard_scores(queries).numpy()
    want = np.asarray(jri.router.shard_scores(queries))
    scale = (queries * queries).sum(-1)[:, None] + \
        ri.router.cnorm.numpy().max(-1)[None, :]
    assert (np.abs(score - want) <= 1e-6 * scale).all()
    for r in (1, 2, S):
        np.testing.assert_array_equal(ri.router.route(queries, r),
                                      jri.router.route(queries, r))
    tgt = ri.router.route(queries, 1)[:, 0]
    d2 = ((ri.db[None] - queries[:, None]) ** 2).sum(-1)
    assert (tgt == d2.argmin(-1) // (N // S)).mean() >= 0.75


# ---------------------------------------------------------------------------
# fusion
# ---------------------------------------------------------------------------
def _fuse_both(leg_d, leg_i, k=None):
    got = fuse_topk(leg_d, leg_i, KernelBackend(mode="ref"), k, **CPU)
    want = J.fuse_topk(leg_d, leg_i, JBackend(mode="jnp"), k)
    return (got[0].numpy(), got[1].numpy()), tuple(np.asarray(x)
                                                   for x in want)


@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_fuse_topk_matches_numpy(R):
    rng = np.random.default_rng(3)
    k = 6
    leg_d = np.sort(rng.random((5, R, k)).astype(np.float32), -1)
    leg_i = rng.permutation(5 * R * k).astype(np.int32).reshape(5, R, k)
    leg_i[:, :, -1] = np.where(rng.random((5, R)) < 0.5, INVALID,
                               leg_i[:, :, -1])
    (fd, fi), (jd, ji) = _fuse_both(leg_d, leg_i)
    np.testing.assert_array_equal(fd.view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(fi, ji)
    for q in range(5):
        pairs = sorted((leg_d[q, r, j], leg_i[q, r, j]) for r in range(R)
                       for j in range(k) if leg_i[q, r, j] != INVALID)
        np.testing.assert_array_equal(fd[q, :len(pairs[:k])],
                                      [p[0] for p in pairs[:k]])


def test_fuse_topk_all_invalid_legs():
    """All-INVALID legs fuse to all-INVALID ids over BIG_DIST, never
    INVALID ids over stale 0.0 distances; a partial row keeps its real
    entry; bit for bit the reference's."""
    k, R = 6, 3
    leg_d = np.zeros((3, R, k), np.float32)
    leg_i = np.full((3, R, k), INVALID, np.int32)
    leg_i[1, 0, 0] = 42
    leg_d[1, 0, 0] = 0.5
    (fd, fi), (jd, ji) = _fuse_both(leg_d, leg_i)
    np.testing.assert_array_equal(fd.view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(fi, ji)
    assert (fi[0] == INVALID).all() and (fd[0] == BIG_DIST).all()
    assert fi[1, 0] == 42 and fd[1, 0] == np.float32(0.5)
    assert (fi[1, 1:] == INVALID).all() and (fd[1, 1:] == BIG_DIST).all()


def test_fuse_topk_quarantines_nonfinite():
    """NaN leg distances sort last like padding and real entries win;
    a quarantined real id and an entry at the engine's BIG_DIST keep the
    reference's order (the merge's own filler sorts before BIG_DIST)."""
    leg_d = np.array([[[0.1, 0.2, 0.3, 0.4],
                       [np.nan, np.nan, np.nan, np.nan]],
                      [[0.1, 3.0e38, 0.0, 0.0],
                       [np.inf, 0.0, 0.0, 0.0]]], np.float32)
    leg_i = np.array([[[1, 2, 3, 4], [5, 6, 7, 8]],
                      [[9, 10, INVALID, INVALID],
                       [11, INVALID, INVALID, INVALID]]], np.int32)
    (fd, fi), (jd, ji) = _fuse_both(leg_d, leg_i)
    np.testing.assert_array_equal(fi[0], [1, 2, 3, 4])
    assert np.isfinite(fd).all()
    np.testing.assert_array_equal(fd.view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(fi, ji)
    np.testing.assert_array_equal(fi[1], [9, 10, INVALID, INVALID])


# ---------------------------------------------------------------------------
# R=S: routed == fan-out, bit for bit
# ---------------------------------------------------------------------------
def _fanout_identity(rds, engine, slots, arrivals, injit):
    _, queries, ri, _ = rds
    consts, geom, entry = engine
    q = queries[:len(arrivals)]
    params = _params(SearchParams(L=16, W=1, k=8), slots, geom)
    ref_i, ref_d, _ = stream_search(consts, geom, params, entry, q,
                                    num_slots=slots, arrivals=arrivals,
                                    injit_admit=injit, **CPU)
    ids, dists, st = routed_stream_search(
        consts, geom, params, entry, q, router=ri.router, topr=S,
        num_slots=slots, arrivals=arrivals, injit_admit=injit, **CPU)
    np.testing.assert_array_equal(ref_i, ids)
    np.testing.assert_array_equal(ref_d, dists)
    assert st.legs == len(q)


def test_routed_full_fanout_bitidentical_property(rds, engine):
    """Seeded cases in place of the reference's hypothesis property:
    slots, arrival gaps, shuffled orders and the admission path."""
    rng = np.random.default_rng(11)
    nq = 8
    for _ in range(4):
        order = rng.permutation(nq)
        arrivals = np.zeros(nq, np.int64)
        arrivals[order] = np.cumsum(rng.integers(0, 11, nq))
        _fanout_identity(rds, engine, int(rng.integers(1, 5)), arrivals,
                         bool(rng.integers(2)))


@pytest.mark.parametrize("injit,slots", [(False, 3), (True, 2)])
def test_routed_full_fanout_bitidentical(rds, engine, injit, slots):
    rng = np.random.default_rng(slots)
    _fanout_identity(rds, engine, slots,
                     np.cumsum(rng.integers(0, 5, 8)).astype(np.int64),
                     injit)


# ---------------------------------------------------------------------------
# R<S: recall floor
# ---------------------------------------------------------------------------
def test_routed_r2_recall_floor(rds, engine):
    _, queries, ri, _ = rds
    consts, geom, entry = engine
    params = _params(SearchParams(L=32, W=1, k=8), 4, geom)
    arr = np.zeros(len(queries), np.int64)
    ref_i, _, _ = stream_search(consts, geom, params, entry, queries,
                                num_slots=4, arrivals=arr, **CPU)
    ids, _, st2 = routed_stream_search(
        consts, geom, params, entry, queries, router=ri.router, topr=2,
        num_slots=4, arrivals=arr, shard_entries=ri.shard_entries, **CPU)
    d2 = ((ri.db[None] - queries[:, None]) ** 2).sum(-1)
    gt = np.argsort(d2, -1)[:, :8]
    assert _recall(ids, gt) >= _recall(ref_i, gt) - 0.05
    assert len(st2.results) == len(queries)
    assert st2.legs == 2 * len(queries)


# ---------------------------------------------------------------------------
# independent schedules: a shard with no routed legs does zero work
# ---------------------------------------------------------------------------
class _FixedRouter:
    """Routes every query to a fixed shard subset (test stub)."""

    def __init__(self, targets):
        self._t = np.asarray(targets, np.int32)

    def route(self, queries, topr):
        return np.tile(self._t[:topr], (np.shape(queries)[0], 1))


@pytest.mark.parametrize("injit", [False, True])
def test_idle_shard_zero_distance_work(rds, engine, injit):
    _, queries, ri, _ = rds
    consts, geom, entry = engine
    params = _params(SearchParams(L=16, W=1, k=8), 4, geom)
    _, _, st = routed_stream_search(
        consts, geom, params, entry, queries, router=_FixedRouter([0, 2]),
        topr=2, num_slots=4, arrivals=np.arange(len(queries)),
        shard_entries=ri.shard_entries, injit_admit=injit, **CPU)
    items = np.asarray(st.items_by_shard)
    assert items[1] == 0 and items[3] == 0
    assert items[0] > 0 and items[2] > 0
    assert len(st.results) == len(queries)


# ---------------------------------------------------------------------------
# degraded routed fusion
# ---------------------------------------------------------------------------
def test_routed_down_shard_degrades(rds, engine):
    """One routed shard down: its legs are dropped, every query retires
    from its surviving legs with coverage 0.5 where a leg was lost, the
    others fuse as in the healthy run, and the histogram adds up."""
    _, queries, ri, _ = rds
    consts, geom, entry = engine
    params = _params(SearchParams(L=32, W=1, k=8), 4, geom)
    nq = len(queries)
    kw = dict(router=ri.router, topr=2, num_slots=4,
              arrivals=np.zeros(nq, np.int64),
              shard_entries=ri.shard_entries, **CPU)
    ids0, _, _ = routed_stream_search(consts, geom, params, entry, queries,
                                      **kw)
    ids, dists, st = routed_stream_search(consts, geom, params, entry,
                                          queries, down_shards=[1], **kw)
    assert len(st.results) == nq
    hit = (ri.router.route(queries, 2) == 1).any(-1)
    assert st.truncated == int(hit.sum()) > 0
    assert st.legs == 2 * nq - int(hit.sum())
    assert sum(st.legs_fused_hist) == nq
    assert st.legs_fused_hist[2] == nq - int(hit.sum())
    by = st.by_qid()
    for i in range(nq):
        r = by[i]
        if hit[i]:
            assert r.truncated and r.legs_fused == 1
            assert r.coverage == pytest.approx(0.5)
        else:
            assert not r.truncated and r.legs_fused == 2
            assert r.coverage == 1.0
            np.testing.assert_array_equal(ids[i], ids0[i])
    assert (dists[ids == INVALID] > 1e30).all()


def test_routed_all_shards_down_query(rds, engine):
    """A query routed only to down shards retires at once with
    all-INVALID ids over BIG_DIST and coverage 0; every shard down is
    refused."""
    _, queries, ri, _ = rds
    consts, geom, entry = engine
    params = _params(SearchParams(L=16, W=1, k=8), 4, geom)
    q = queries[:8]
    tgt = ri.router.route(q, 1)[:, 0]
    down = int(tgt[0])
    ids, dists, st = routed_stream_search(
        consts, geom, params, entry, q, router=ri.router, topr=S,
        num_slots=4, down_shards=[down], **CPU)
    assert len(st.results) == len(q)
    by = st.by_qid()
    for i in range(len(q)):
        r = by[i]
        if tgt[i] == down:
            assert r.truncated and r.legs_fused == 0
            assert r.coverage == 0.0 and r.service_rounds == 0
            assert (ids[i] == INVALID).all() and (dists[i] > 1e30).all()
        else:
            assert not r.truncated and r.coverage == 1.0
    with pytest.raises(ValueError, match="every shard"):
        routed_stream_search(consts, geom, params, entry, q,
                             router=ri.router, topr=S, num_slots=4,
                             down_shards=list(range(S)), **CPU)


# ---------------------------------------------------------------------------
# the per-leg list length
# ---------------------------------------------------------------------------
def test_default_leg_l_tracks_shard_depth():
    for args in ((128, 8, 8), (256, 16, 10), (4096, 4, 8), (4096, 32, 8),
                 (1, 2, 5), (1, 1, 5), (2**15, 8, 8)):
        assert default_leg_L(*args) == j_default_leg_L(*args)
    assert default_leg_L(128, 8, 8) == 8 + 2 * 3
    vals = [default_leg_L(n, 8, 8) for n in (2, 64, 512, 4096, 2**15)]
    assert vals == sorted(vals)


def test_routed_leg_l_override_wins():
    """An explicit leg_L overrides the default: more distance work at 16
    than at k + 2 * depth, reproducible, and equal to the reference's
    session at both lengths (ids; distances within f32 rounding on
    this real-valued data)."""
    rng = np.random.default_rng(3)
    n, d = 512, 16
    db = rng.standard_normal((n, d)).astype(np.float32)
    queries = rng.standard_normal((6, d)).astype(np.float32)
    kw = dict(shards=S, page_size=16, r=8, seed=0)
    ri = build_routed_index(db, kernel_mode="ref", **kw, **CPU)
    jri = J.build_routed_index(db, **kw)
    consts, geom, entry = pack_for_engine(ri.packed, **CPU)
    jc, jg, je = j_pack_for_engine(jri.packed)

    def run(leg_l):
        ids, dists, st = routed_stream_search(
            consts, geom, _params(SearchParams(L=16, W=1, k=4), 2, geom),
            entry, queries, router=ri.router, topr=2, num_slots=2,
            shard_entries=ri.shard_entries, leg_L=leg_l, **CPU)
        jids, jdists, _ = j_routed(
            jc, jg, JEngineParams.lossless(JSearchParams(L=16, W=1, k=4), 2,
                                           jg.max_degree),
            je, queries, router=jri.router, topr=2, num_slots=2,
            shard_entries=jri.shard_entries, leg_L=leg_l)
        np.testing.assert_array_equal(ids, np.asarray(jids))
        np.testing.assert_allclose(dists, np.asarray(jdists), rtol=1e-5)
        return ids, dists, sum(r.n_dist for r in st.results)

    _, _, auto_nd = run(None)
    big_i, big_d, big_nd = run(16)
    assert big_nd > auto_nd
    again_i, again_d, again_nd = run(16)
    np.testing.assert_array_equal(big_i, again_i)
    np.testing.assert_array_equal(big_d, again_d)
    assert big_nd == again_nd


# ---------------------------------------------------------------------------
# whole routed sessions against the reference, on integer-valued data
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def int_routed():
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(N, D)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(24, D)).astype(np.float32)
    kw = dict(shards=S, page_size=PAGE, r=R_DEG, centroids_per_shard=4,
              seed=0)
    ri = build_routed_index(db, kernel_mode="ref", **kw, **CPU)
    jri = J.build_routed_index(db, **kw)
    arrivals = np.cumsum(rng.integers(0, 3, len(queries)))
    return (queries, arrivals, (ri, pack_for_engine(ri.packed, **CPU)),
            (jri, j_pack_for_engine(jri.packed)))


def _leg_records(st):
    """Every per-query field but the wall time, by qid (distances by
    their bits)."""
    return {r.qid: (tuple(r.ids), tuple(np.asarray(r.dists).view(np.int32)),
                    r.arrival_round, r.admit_round, r.retire_round,
                    r.service_rounds, r.n_dist, r.truncated, r.legs_fused,
                    r.coverage, r.stall_rounds) for r in st.results}


def _sessions(int_routed, topr, injit, down=None, kill=False, chunk=4):
    queries, arrivals, (ri, (pc, pg, pe)), (jri, (jc, jg, je)) = int_routed
    sp = dict(L=16, W=1, k=8)
    extra, jextra = {}, {}
    if kill:
        extra = dict(faults=fault_plan(S).kill(1, 3), deadline_rounds=10)
        jextra = dict(faults=j_fault_plan(S).kill(1, 3), deadline_rounds=10)
    params = EngineParams.lossless(SearchParams(**sp), 3, R_DEG,
                                   kernel_mode="ref", **extra)
    jparams = JEngineParams.lossless(JSearchParams(**sp), 3, R_DEG,
                                     kernel_mode="jnp", **jextra)
    kw = dict(topr=topr, num_slots=3, arrivals=arrivals, round_chunk=chunk,
              injit_admit=injit, down_shards=down)
    got = routed_stream_search(pc, pg, params, pe, queries, router=ri.router,
                               shard_entries=ri.shard_entries, **kw, **CPU)
    want = j_routed(jc, jg, jparams, je, queries, router=jri.router,
                    shard_entries=jri.shard_entries, **kw)
    return got, want


def _same_session(got, want):
    (ids, dists, st), (jids, jdists, jst) = got, want
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(dists.view(np.int32),
                                  np.asarray(jdists).view(np.int32))
    assert _leg_records(st) == _leg_records(jst)
    for f in ("legs", "legs_fused_hist", "items_by_shard", "truncated",
              "total_rounds", "occupancy_trace", "idle_rounds", "stalls",
              "pages_unique", "props_sent"):
        assert getattr(st, f) == getattr(jst, f), f
    summ, jsumm = stream_summary(st), j_stream_summary(jst)
    for key in set(jsumm) - CLOCKS:
        assert summ[key] == jsumm[key], key


@pytest.mark.parametrize("down", [None, [1]])
@pytest.mark.parametrize("injit", [False, True])
@pytest.mark.parametrize("topr", [2, S])
def test_routed_session_matches_reference(int_routed, topr, injit, down):
    """Routed sessions on an integer-valued routed index: ids, distance
    bits, every per-query record, legs, the fused-legs histogram, work
    per shard and the serving summary equal the reference's."""
    _same_session(*_sessions(int_routed, topr, injit, down))


@pytest.mark.parametrize("topr", [2, S])
def test_routed_session_kill_deadline_matches_reference(int_routed, topr):
    """A shard killed mid-run under a deadline: its legs force-retire
    truncated and fuse degraded, as in the reference."""
    got, want = _sessions(int_routed, topr, True, kill=True)
    _same_session(got, want)
    assert got[2].truncated > 0


def test_routed_params_are_the_references():
    """EngineParams keeps the reference's local_only field."""
    fields = {f.name for f in dataclasses.fields(EngineParams)}
    assert "local_only" in fields and \
        "local_only" in {f.name for f in dataclasses.fields(JEngineParams)}
