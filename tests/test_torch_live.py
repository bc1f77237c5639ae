"""The live index on the port (core/live.py, the live retire in
core/engine.py, the scheduler's live boundary and epoch swap) against
the reference's: twins of tests/test_live.py on its fixture (n0 256,
d 16, 2 shards, page 8, degree 8), each run in both packages on one
numpy index from a seed, the port on the CPU.

Here: the host pieces array for array (``pack_padded``, the epoch
index, ``mutation_schedule``, ``reindex_epoch`` keeping external ids,
``refresh_router``), the live retire against the reference's, the
zero-churn identity with the frozen path, the tombstone guarantee, the
bounded delta and the capacity limit, a swap's restart of rows whose
whole list died, and recall on real-valued data against the reference's
and against a cold rebuild. The hypothesis properties of the reference
file are seeded parametrised cases here. Whole mutation sessions through
several swaps (flat, routed, tiered) are tests/test_torch_live_sessions.py.
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import live as JL
from repro.core import luncsr as JLU
from repro.core import refresh as JR
from repro.core import router as JRT
from repro.core.engine import EngineParams as JEngineParams
from repro.core.engine import pack_for_engine as j_pack_for_engine
from repro.core.pagestore import PageStore as JPageStore
from repro.core.ref_search import SearchParams as JSearchParams
from repro.core.scheduler import StreamScheduler as JStreamScheduler
from repro.core.scheduler import stream_search as j_stream_search
from repro_torch.core import engine as E
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.graph import brute_force_topk, recall_at_k
from repro_torch.core.live import (LiveIndex, build_live_index,
                                   live_index_from_graph, mutation_schedule)
from repro_torch.core.luncsr import EpochIndex, Geometry, pack_padded
from repro_torch.core.pagestore import PageStore
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.refresh import reindex_epoch
from repro_torch.core.router import build_live_router, refresh_router
from repro_torch.core.scheduler import (StreamScheduler, routed_stream_search,
                                        stream_search)
from repro_torch.launch.search import build_index
from repro_torch.utils import ID_SENTINEL, bloom_pack

N0, D, NQ = 256, 16, 16
SHARDS, PAGE, R = 2, 8, 8
CPU = dict(device="cpu")
PACKED = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
          "blk_perm")
EPOCH = ("vectors", "ext_ids", "tombs", "delta_vec", "delta_norm",
         "delta_live", "delta_ext")


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
    """Integer-valued vectors and queries (every distance exact in f32),
    and tests/test_live.py's real-valued ones."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, (N0, D)).astype(np.float32)
    queries = rng.integers(-8, 9, (NQ, D)).astype(np.float32)
    frng = np.random.default_rng(0)
    fdb = frng.standard_normal((N0, D)).astype(np.float32)
    fq = frng.standard_normal((NQ, D)).astype(np.float32)
    return db, queries, fdb, fq


def _params(delta_cap=0, k=8, spec=0):
    p = EngineParams.lossless(SearchParams(L=16, W=1, k=k), 2, R,
                              spec_width=spec, kernel_mode="ref")
    return dataclasses.replace(p, delta_cap=delta_cap)


def _jparams(delta_cap=0, k=8, spec=0):
    p = JEngineParams.lossless(JSearchParams(L=16, W=1, k=k), 2, R,
                               spec_width=spec)
    return dataclasses.replace(p, delta_cap=delta_cap)


def _lives(db, **kw):
    """One live index per package over ``db`` (the port's, the
    reference's); ``schedule`` is the reference's and is carried across."""
    kw = dict(shards=SHARDS, page_size=PAGE, r=R, seed=3, **kw)
    jl = JL.build_live_index(db, **kw)
    sched = kw.pop("schedule", None)
    if sched is not None:
        kw["schedule"] = _port_schedule(sched)
    return build_live_index(db, **kw), jl


def _port_schedule(s):
    from repro_torch.core.live import MutationSchedule
    return MutationSchedule(t=s.t, is_ins=s.is_ins, vec=s.vec)


def _assert_epoch_equal(ep, jep):
    assert ep.epoch == jep.epoch and ep.delta_len == jep.delta_len
    for name in EPOCH:
        np.testing.assert_array_equal(getattr(ep, name), getattr(jep, name),
                                      err_msg=name)
    for name in PACKED:
        np.testing.assert_array_equal(getattr(ep.packed, name),
                                      getattr(jep.packed, name),
                                      err_msg=name)
    assert ep.packed.entry == jep.packed.entry


def _schedule_of(st):
    return {r.qid: (r.admit_round, r.retire_round, r.service_rounds,
                    r.stall_rounds, r.n_dist) for r in st.results}


# ---------------------------------------------------------------------------
# host pieces, array for array
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("extra", [0, 5, 13])
def test_pack_padded_matches_reference(data, extra):
    """Packing m vertices at capacity m + extra: the reference's arrays;
    the pad seats are zero vectors with INVALID adjacency."""
    from repro_torch.core.graph import build_vamana
    db = data[0]
    adj, med = build_vamana(db, r=R, seed=3)
    geom = Geometry(num_shards=SHARDS, page_size=PAGE, pages_per_block=4,
                    dim=D)
    jgeom = JLU.Geometry(num_shards=SHARDS, page_size=PAGE,
                         pages_per_block=4, dim=D)
    got = pack_padded(db, adj, geom, med, R, capacity=N0 + extra,
                      pref_width=2)
    jpacked = JLU.pack_padded(db, adj, jgeom, med, R, capacity=N0 + extra,
                              pref_width=2)
    assert got.n == N0 + extra
    for name in PACKED:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(jpacked, name), err_msg=name)
    if extra == 0:
        frozen = build_index(db, shards=SHARDS, page_size=PAGE, r=R,
                             reorder="none", pref_width=2, seed=3)[1]
        for name in PACKED:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(frozen, name))
    with pytest.raises(ValueError, match="exceed capacity"):
        pack_padded(db, adj, geom, med, R, capacity=N0 - 1)


def test_epoch_index_and_live_consts(data):
    """``EpochIndex.empty`` and the live index's consts: the reference's
    arrays, as tensors of a fixed shape on the device asked for."""
    live, jlive = _lives(data[0], delta_cap=4, capacity=N0 + 4)
    _assert_epoch_equal(live.ep, jlive.ep)
    assert (live.capacity, live.delta_cap) == (N0 + 4, 4)
    consts = live.live_consts("cpu")
    jconsts = jlive.live_consts()
    assert set(consts) == set(E.LIVE_CONST_KEYS) == set(jconsts)
    for name, t in consts.items():
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(jconsts[name]))
    main, jmain = live.main_consts("cpu"), jlive.main_consts()
    for name in main:
        np.testing.assert_array_equal(main[name].numpy(),
                                      np.asarray(jmain[name]))
    ev, en, ei = live.device_entry("cpu")
    jev, jen, jei = jlive.device_entry()
    np.testing.assert_array_equal(ev.numpy(), np.asarray(jev))
    assert float(en) == float(jen) and int(ei) == int(jei)
    assert ei.dtype == torch.int32
    host = live.main_consts("cpu", host_pages=True)
    assert host["db"].device.type == "cpu"


def test_live_index_from_graph_equals_build(data):
    """Epoch 0 from an already built graph is build_live_index's."""
    from repro_torch.core.graph import build_vamana
    from repro_torch.core.reorder import (apply_reordering,
                                          degree_ascending_bfs)
    db = data[0]
    want = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, capacity=N0 + 7, seed=3)
    adj, med = build_vamana(db, r=R, seed=3)
    vecs, adj, entry = apply_reordering(db, adj, degree_ascending_bfs(adj),
                                        entry=med)
    got = live_index_from_graph(vecs, adj, entry, shards=SHARDS,
                                page_size=PAGE, r=R, delta_cap=4,
                                capacity=N0 + 7, seed=3)
    _assert_epoch_equal(got.ep, want.ep)


@pytest.mark.parametrize("rates,seed,ref", [
    ((0.2, 0.05), 7, True), ((0.35, 0.1), 5, False), ((0.0, 0.4), 1, True),
    ((0.5, 0.0), 2, False)])
def test_mutation_schedule_matches_reference(data, rates, seed, ref):
    got = mutation_schedule(*rates, 80, D, seed=seed,
                            ref=data[0] if ref else None)
    want = JL.mutation_schedule(*rates, 80, D, seed=seed,
                                ref=data[0] if ref else None)
    for name in ("t", "is_ins", "vec"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.num_inserts == want.num_inserts and len(got) == len(want)


def test_reindex_epoch_matches_reference_and_keeps_external_ids(data):
    """A reindex after inserts and deletes of both kinds: the reference's
    epoch array for array, every survivor under its external id, the
    delta and tombstones cleared."""
    live, jlive = _lives(data[0], delta_cap=8, capacity=N0 + 8)
    rng = np.random.default_rng(2)
    new = []
    for _ in range(3):
        v = rng.integers(-8, 9, D).astype(np.float32)
        new.append(live.insert(v))
        assert jlive.insert(v) == new[-1]
    for lx in (live, jlive):
        lx.delete(5)
        lx.delete(new[1])
    ep = reindex_epoch(live.ep, seed=11, pref_width=2)
    jep = JR.reindex_epoch(jlive.ep, seed=11, pref_width=2)
    _assert_epoch_equal(ep, jep)
    for lx in (live, jlive):
        lx.refresh()
    _assert_epoch_equal(live.ep, jlive.ep)
    got = {int(e) for e in live.ep.ext_ids if e >= 0}
    assert got == (set(range(N0)) - {5}) | {new[0], new[2]}
    assert live.ep.delta_len == 0 and not live.ep.tombs.any()
    assert live.take_translation().shape == (N0 + 8,)


def test_refresh_router_matches_reference(data):
    """The live router's sketches, refit after a swap: the reference's
    centroids, and the same routes."""
    db, queries = data[:2]
    live, jlive = _lives(db, delta_cap=8, capacity=N0 + 8)
    router = build_live_router(live.ep, centroids_per_shard=4, seed=1,
                               kernel_mode="ref", **CPU)
    jrouter = JRT.build_live_router(jlive.ep, centroids_per_shard=4, seed=1)
    np.testing.assert_array_equal(router.centroids.numpy(),
                                  np.asarray(jrouter.centroids))
    rng = np.random.default_rng(0)
    for _ in range(6):
        v = rng.integers(-8, 9, D).astype(np.float32)
        live.insert(v)
        jlive.insert(v)
    live.refresh()
    jlive.refresh()
    r2 = refresh_router(router, live.ep, seed=2)
    jr2 = JRT.refresh_router(jrouter, jlive.ep, seed=2)
    assert r2.centroids.shape == router.centroids.shape == (SHARDS, 4, D)
    np.testing.assert_array_equal(r2.centroids.numpy(),
                                  np.asarray(jr2.centroids))
    np.testing.assert_array_equal(r2.cnorm.numpy(), np.asarray(jr2.cnorm))
    np.testing.assert_array_equal(r2.route(queries, SHARDS),
                                  np.asarray(jr2.route(queries, SHARDS)))


def test_full_delta_forces_refresh(data):
    db = data[0]
    live = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=2, capacity=N0 + 5, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(5):
        live.insert(rng.standard_normal(D).astype(np.float32))
        assert live.ep.delta_len <= 2
    assert live.swaps >= 2
    assert live.ep.n_live() == N0 + 5


def test_capacity_exhaustion_raises(data):
    live = build_live_index(data[0], shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, capacity=N0 + 1, seed=3)
    live.insert(np.zeros(D, np.float32))
    with pytest.raises(ValueError, match="capacity"):
        live.insert(np.ones(D, np.float32))


# ---------------------------------------------------------------------------
# the live retire
# ---------------------------------------------------------------------------
def _retire_inputs(seed, dcap=6, L=16, k=8):
    """A random (S, Qs, L) candidate state with sentinels, ties and
    duplicated distances, tombstones, and a delta segment with dead rows,
    all integer-valued."""
    rng = np.random.default_rng(seed)
    S, Qs, cap = SHARDS, 3, 40
    cand_i = rng.integers(0, cap, (S, Qs, L)).astype(np.int32)
    cand_i[:, :, L - 3:] = ID_SENTINEL
    cand_d = np.sort(rng.integers(0, 200, (S, Qs, L)), -1).astype(np.float32)
    cand_d[:, :, L - 3:] = 3.0e38
    queries = rng.integers(-3, 4, (S, Qs, D)).astype(np.float32)
    tombs = rng.random(cap) < 0.3
    dvec = rng.integers(-3, 4, (dcap, D)).astype(np.float32)
    dnorm = (dvec.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    dlive = rng.random(dcap) < 0.7
    stats = {n: rng.integers(0, 9, (S, Qs) if n in ("rounds", "n_dist")
                             else (S,)).astype(np.int32)
             for n in ("rounds", "n_dist", "items_recv", "pages_unique",
                       "drops_b", "props_sent", "quarantined")}
    stats["truncated"] = np.zeros((S, Qs), bool)
    return cand_i, cand_d, queries, tombs, dvec, dnorm, dlive, stats, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_live_matches_reference(seed):
    """The live retire over every shard: the reference's per-shard
    ``_finalize_live`` bit for bit (stable partition of tombstones, the
    delta's ids after capacity, ties kept in position)."""
    ci, cd, q, tombs, dvec, dnorm, dlive, stats, k = _retire_inputs(seed)
    st = types.SimpleNamespace(cand_i=torch.as_tensor(ci),
                               cand_d=torch.as_tensor(cd),
                               **{n: torch.as_tensor(v)
                                  for n, v in stats.items()})
    out_i, out_d, _ = E.engine_retire_live(
        st, torch.as_tensor(q), torch.as_tensor(tombs),
        torch.as_tensor(dvec), torch.as_tensor(dnorm),
        torch.as_tensor(dlive), k)
    for s in range(SHARDS):
        jst = types.SimpleNamespace(cand_i=jnp.asarray(ci[s]),
                                    cand_d=jnp.asarray(cd[s]),
                                    **{n: jnp.asarray(v[s] if v.ndim == 2
                                                      else v[s:s + 1])
                                       for n, v in stats.items()})
        wi, wd, _ = JE._finalize_live(jst, jnp.asarray(q[s]),
                                      jnp.asarray(tombs), jnp.asarray(dvec),
                                      jnp.asarray(dnorm), jnp.asarray(dlive),
                                      k)
        np.testing.assert_array_equal(out_i[s].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(out_d[s].numpy(), np.asarray(wd))
    assert (out_i >= 40).any(), "the delta never reached the top k"


def test_finalize_live_at_rest_is_finalize():
    """No tombstone and no live delta row: the live retire is the frozen
    one."""
    ci, cd, q, tombs, dvec, dnorm, dlive, stats, k = _retire_inputs(3)
    st = types.SimpleNamespace(cand_i=torch.as_tensor(ci),
                               cand_d=torch.as_tensor(cd),
                               **{n: torch.as_tensor(v)
                                  for n, v in stats.items()})
    got = E.engine_retire_live(st, torch.as_tensor(q),
                               torch.zeros(len(tombs), dtype=torch.bool),
                               torch.as_tensor(dvec), torch.as_tensor(dnorm),
                               torch.zeros(len(dlive), dtype=torch.bool), k)
    want = E.engine_retire(st, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------------------
# zero churn == the frozen path, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def frozen(data):
    db, queries = data[:2]
    live = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, seed=3)
    return pack_for_engine(live.ep.packed, **CPU)


@pytest.mark.parametrize("seed", [None, 0, 1, 2])
def test_zero_churn_bitidentical(data, frozen, seed):
    """A live session with no mutation equals the frozen session in ids,
    dists, dispatches, rounds and schedule, and the reference's live
    session in ids and dists (the hypothesis property of the reference's
    file as seeded arrival orders and gaps)."""
    db, queries = data[:2]
    consts, geom, entry = frozen
    arrivals = None
    if seed is not None:
        rng = np.random.default_rng(seed)
        arrivals = np.zeros(NQ, np.int64)
        arrivals[rng.permutation(NQ)] = np.cumsum(rng.integers(0, 7, NQ))
    fi, fd, fs = stream_search(consts, geom, _params(), entry, queries,
                               num_slots=2, arrivals=arrivals, **CPU)
    live = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, seed=3)
    li, ld, ls = stream_search(consts, geom, _params(4), entry, queries,
                               num_slots=2, arrivals=arrivals, live=live,
                               **CPU)
    np.testing.assert_array_equal(fi, li)
    np.testing.assert_array_equal(fd, ld)
    assert fs.host_dispatches == ls.host_dispatches
    assert fs.total_rounds == ls.total_rounds
    assert _schedule_of(fs) == _schedule_of(ls)
    assert (ls.delta_hits, ls.tombstoned, ls.epoch_swaps,
            ls.swap_stall_rounds) == (0, 0, 0, 0)
    if seed is None:
        jlive = JL.build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                                    delta_cap=4, seed=3)
        jc, jg, je = j_pack_for_engine(jlive.ep.packed)
        wi, wd, ws = j_stream_search(jc, jg, _jparams(4), je, queries,
                                     num_slots=2, live=jlive)
        np.testing.assert_array_equal(li, np.asarray(wi))
        np.testing.assert_array_equal(ld, np.asarray(wd))
        assert _schedule_of(ls) == _schedule_of(ws)


# ---------------------------------------------------------------------------
# tombstone guarantee
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("doomed,seed", [
    ((0, 17, 100, 255), 3), ((1, 2, 3), 11), ((7, 64, 128, 129, 200), 42)])
def test_tombstoned_id_never_in_results(data, doomed, seed):
    """Ids deleted before the run (main vertices and a delta insert)
    never appear in a result, and the results are the reference's."""
    db, queries = data[:2]
    outs = []
    for pkg, ss, pack, params in (
            ("port", stream_search, lambda p: pack_for_engine(p, **CPU),
             _params(4)),
            ("ref", j_stream_search, j_pack_for_engine, _jparams(4))):
        mod = JL if pkg == "ref" else None
        build = JL.build_live_index if mod else build_live_index
        live = build(db, shards=SHARDS, page_size=PAGE, r=R, delta_cap=4,
                     capacity=N0 + 4, seed=seed)
        new_ext = live.insert(db[0] + 1.0)
        for e in (*doomed, new_ext):
            assert live.delete(e)
        consts, geom, entry = pack(live.ep.packed)
        kw = CPU if pkg == "port" else {}
        ids, dists, _ = ss(consts, geom, params, entry, queries,
                           num_slots=2, live=live, **kw)
        ids = np.asarray(ids)
        for e in (*doomed, new_ext):
            assert not (ids == e).any(), f"deleted ext id {e} in results"
        outs.append((ids, np.asarray(dists)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# the scheduler's checks and the swap's restart
# ---------------------------------------------------------------------------
def test_scheduler_checks_the_live_configuration(data, frozen):
    db = data[0]
    consts, geom, entry = frozen
    live = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, seed=3)
    with pytest.raises(ValueError, match="delta_cap > 0"):
        StreamScheduler(consts, geom, _params(), entry, 2, live=live, **CPU)
    with pytest.raises(ValueError, match="live.delta_cap=4"):
        StreamScheduler(consts, geom, _params(8), entry, 2, live=live, **CPU)
    with pytest.raises(ValueError, match="needs a LiveIndex"):
        StreamScheduler(consts, geom, _params(4), entry, 2, **CPU)
    big = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                           delta_cap=4, capacity=N0 + 8, seed=3)
    with pytest.raises(ValueError, match="live capacity"):
        StreamScheduler(consts, geom, _params(4), entry, 2, live=big, **CPU)


def test_routed_live_requires_full_fanout(data):
    db, queries = data[:2]
    live = build_live_index(db, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, seed=3)
    router = build_live_router(live.ep, centroids_per_shard=4,
                               kernel_mode="ref", **CPU)
    consts, geom, entry = pack_for_engine(live.ep.packed, **CPU)
    with pytest.raises(ValueError, match="topr >= num_shards"):
        routed_stream_search(consts, geom, _params(4), entry, queries,
                             router=router, topr=1, num_slots=2, live=live,
                             **CPU)


def test_swap_restarts_dead_rows_like_reference(data):
    """An epoch swap under in-flight rows, in both packages' schedulers:
    a row whose whole candidate list was deleted restarts from the new
    entry with its worked rounds counted as the swap's stall and its age
    carried; the other rows' lists are translated into the new epoch's
    ids, compacted, and their bloom filters rebuilt, as the
    reference's."""
    db, queries = data[:2]
    live, jlive = _lives(db, delta_cap=4, capacity=N0)
    consts, geom, entry = pack_for_engine(live.ep.packed, **CPU)
    jc, jg, je = j_pack_for_engine(jlive.ep.packed)
    sched = StreamScheduler(consts, geom, _params(4), entry, 2, live=live,
                            **CPU)
    jsched = JStreamScheduler(jc, jg, _jparams(4), je, 2, live=jlive)
    mask = np.ones((SHARDS, 2), bool)
    newq = queries[:4].reshape(SHARDS, 2, D)
    state = sched._fresh_pool(torch.zeros((SHARDS, 2, D)))
    state, qbuf = sched.stepper.admit(
        state, torch.zeros((SHARDS, 2, D)), torch.as_tensor(mask),
        torch.as_tensor(newq), *sched.entry)
    jstate, jq = jsched._fresh_pool(D)
    jstate, jq = jsched.stepper.admit(jstate, jq, jnp.asarray(mask),
                                      jnp.asarray(newq), *jsched.entry)
    owner = np.arange(SHARDS * 2).reshape(SHARDS, 2)
    bases = [np.zeros((SHARDS, 2), np.int64) for _ in range(4)]

    def step():
        nonlocal state, jstate
        for _ in range(2):
            state = sched.stepper.round(sched.consts, state, qbuf, 0)
            jstate = jsched.stepper.round(jsched.consts, jstate, jq, 0)

    def swap(doomed):
        nonlocal state, qbuf, jstate, jq
        for lx in (live, jlive):
            for e in doomed:
                lx.delete(e)
            lx.refresh()
        state, qbuf, stall = sched._swap_epoch(state, qbuf, owner,
                                               *bases[:2])
        jstate, jq, jstall = jsched._swap_epoch(jstate, jq, owner,
                                                *bases[2:])
        assert stall == jstall
        np.testing.assert_array_equal(bases[0], bases[2])
        np.testing.assert_array_equal(bases[1], bases[3])
        for name in ("cand_i", "cand_d", "cand_e", "done", "rounds", "age"):
            np.testing.assert_array_equal(getattr(state, name).numpy(),
                                          np.asarray(getattr(jstate, name)),
                                          err_msg=name)
        np.testing.assert_array_equal(
            bloom_pack(state.bloom).numpy(),
            np.asarray(jstate.bloom).astype(np.int64))
        np.testing.assert_array_equal(qbuf.numpy(), np.asarray(jq))
        return stall

    # a few deletes: every row keeps part of its list, translated
    step()
    before = state.cand_i.clone()
    assert swap([3, 40, 77]) == 0
    assert not torch.equal(state.cand_i, before)
    # every vertex row (0, 1) holds (by external id) dies: it restarts
    # (with any row whose list held nothing else)
    step()
    row = state.cand_i[0, 1].numpy()
    exts = live.ep.ext_ids[row[row != ID_SENTINEL]]
    assert swap([int(e) for e in exts]) > 0
    assert bases[1][0, 1] > 0       # its worked rounds carry over
    # the session's entry and main consts now hold the new epoch's
    ev, _, ei = live.device_entry("cpu")
    assert torch.equal(sched.entry[0], ev) and int(sched.entry[2]) == int(ei)
    np.testing.assert_array_equal(sched.consts["adj"].numpy(),
                                  live.ep.packed.adj)


def test_pagestore_swap_epoch_identity(data):
    """Swapping the same epoch's content into a half-resident store
    leaves its device view unchanged, as the reference's."""
    live, jlive = _lives(data[0], delta_cap=4)
    consts, geom, _ = pack_for_engine(live.ep.packed, host_pages=True, **CPU)
    NP = consts["db"].shape[1]
    ps = PageStore(consts, geom, NP // 2, w_select=1)
    jc, jg, _ = j_pack_for_engine(jlive.ep.packed)
    jps = JPageStore(jc, jg, NP // 2, w_select=1)
    before = {k: v.clone() for k, v in ps.device_view().items()}
    ps.swap_epoch(live.main_consts("cpu", host_pages=True))
    jps.swap_epoch(jlive.main_consts())
    for k, v in ps.device_view().items():
        assert torch.equal(v, before[k]), k
    np.testing.assert_array_equal(ps.frames.numpy(), np.asarray(jps.frames))


# ---------------------------------------------------------------------------
# real-valued data: recall
# ---------------------------------------------------------------------------
def _float_session(fdb, fq, pkg, seed=17):
    sched = JL.mutation_schedule(0.2, 0.05, 80, D, seed=seed, ref=fdb)
    arrivals = np.sort(np.random.default_rng(seed).integers(0, 80, NQ))
    if pkg == "ref":
        live = JL.build_live_index(fdb, shards=SHARDS, page_size=PAGE, r=R,
                                   delta_cap=4, seed=3, refresh_every=6,
                                   schedule=sched)
        c, g, e = j_pack_for_engine(live.ep.packed)
        ids, _, st = j_stream_search(c, g, _jparams(4), e, fq, num_slots=2,
                                     arrivals=arrivals, live=live)
    else:
        live = build_live_index(fdb, shards=SHARDS, page_size=PAGE, r=R,
                                delta_cap=4, seed=3, refresh_every=6,
                                schedule=_port_schedule(sched))
        c, g, e = pack_for_engine(live.ep.packed, **CPU)
        ids, _, st = stream_search(c, g, _params(4), e, fq, num_slots=2,
                                   arrivals=arrivals, live=live, **CPU)
    return np.asarray(ids), st, live


def test_float_session_recall_matches_reference(data):
    """A mutation session on real-valued data (inserts near the data,
    deletes, a reindex every 6 mutations): the port's recall against the
    final live set is the reference's (the two packages round distances
    differently, so ids may swap at near ties), and the host side evolves
    identically."""
    fdb, fq = data[2:]
    ids, st, live = _float_session(fdb, fq, "port")
    jids, jst, jlive = _float_session(fdb, fq, "ref")
    assert st.epoch_swaps == jst.epoch_swaps >= 2
    assert st.tombstoned == jst.tombstoned > 0
    _assert_epoch_equal(live.ep, jlive.ep)
    vecs, exts = live.final_dataset()
    gt = exts[brute_force_topk(vecs, fq, 8)[0]]
    assert abs(recall_at_k(ids, gt) - recall_at_k(jids, gt)) <= 1 / (NQ * 8)
    assert recall_at_k(ids, gt) > 0.2


def test_recall_floor_vs_cold_rebuild(data):
    """After a mixed workload and a final refresh, serving the same
    queries recalls within 0.15 of a cold rebuild over the identical final
    dataset (same params, same seeds)."""
    fdb, fq = data[2:]
    _, _, live = _float_session(fdb, fq, "port")
    live.refresh()      # fold any residual delta: the epoch is all-main
    vecs, exts = live.final_dataset()
    c, g, e = pack_for_engine(live.ep.packed, **CPU)
    ids_live, _, _ = stream_search(c, g, _params(4), e, fq, num_slots=2,
                                   live=live, **CPU)
    rec_live = recall_at_k(ids_live, exts[brute_force_topk(vecs, fq, 8)[0]])
    dbr, cpacked = build_index(vecs, shards=SHARDS, page_size=PAGE, r=R,
                               seed=3)
    cc, cg, ce = pack_for_engine(cpacked, **CPU)
    ids_cold, _, _ = stream_search(cc, cg, _params(), ce, fq, num_slots=2,
                                   **CPU)
    rec_cold = recall_at_k(ids_cold, brute_force_topk(dbr, fq, 8)[0])
    assert rec_live >= rec_cold - 0.15, (rec_live, rec_cold)


@pytest.mark.parametrize("n_ins,seed", [(1, 0), (3, 5), (6, 9)])
def test_recall_floor_after_inserts(data, n_ins, seed):
    """N pure inserts and a refresh: the live set grows by N, the delta
    and tombstones are clear, and serving recalls the final set (the
    reference's hypothesis property as seeded cases)."""
    fdb, fq = data[2:]
    rng = np.random.default_rng(seed)
    live = build_live_index(fdb, shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=8, capacity=N0 + 8, seed=3)
    for _ in range(n_ins):
        base = fdb[rng.integers(0, N0)]
        live.insert(base + 0.1 * rng.standard_normal(D).astype(np.float32))
    live.refresh()
    assert live.ep.delta_len == 0 and not live.ep.tombs.any()
    vecs, exts = live.final_dataset()
    assert vecs.shape[0] == N0 + n_ins
    c, g, e = pack_for_engine(live.ep.packed, **CPU)
    ids, _, _ = stream_search(c, g, _params(8), e, fq, num_slots=2,
                              live=live, **CPU)
    assert recall_at_k(ids, exts[brute_force_topk(vecs, fq, 8)[0]]) > 0.2


def test_live_index_is_host_only(data):
    """The live index holds numpy only; device tensors come from its
    ``*_consts`` / ``device_entry`` calls."""
    live = build_live_index(data[0], shards=SHARDS, page_size=PAGE, r=R,
                            delta_cap=4, seed=3)
    assert isinstance(live, LiveIndex) and isinstance(live.ep, EpochIndex)
    for name in EPOCH:
        assert isinstance(getattr(live.ep, name), np.ndarray)
    assert isinstance(live.ep.packed.db, np.ndarray)
