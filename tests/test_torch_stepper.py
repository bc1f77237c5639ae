"""The port's round-stepper API vs the reference's (jnp mode), bit for bit
on one integer-valued index (the scheduler tests' dataset: n 1024, d 32,
4 shards, page 32, prefetch lists of 8): ``spec_update`` on random
inputs, every state field after interleaved rounds and admissions, and
both chunk drivers' outputs — every trace, ``steps`` and the cursor.
The index crosses packages as plain arrays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as J
from repro.core.graph import build_vamana
from repro.core.luncsr import LUNCSR, Geometry, pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.core.scheduler import _NULL_CFG as J_NULL_CFG
from repro.core.scheduler import SpecController as JSpecController
from repro_torch.core import engine as P
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.ref_search import SearchParams
from repro_torch.utils import bloom_pack

S, SLOTS, L, K_RES, DEG = 4, 2, 16, 10, 12


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


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(1024, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(32, 32)).astype(np.float32)
    adj, medoid = build_vamana(db, r=DEG, alpha=1.2, seed=0)
    geo = Geometry(num_shards=S, page_size=32, pages_per_block=2, dim=32)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=8), max_degree=DEG)
    return (queries, P.pack_for_engine(as_port_index(packed), device="cpu"),
            J.pack_for_engine(packed))


def _params(spec=0, deadline=0):
    return (P.EngineParams.lossless(SearchParams(L=L, W=1, k=K_RES), SLOTS,
                                    DEG, spec_width=spec, kernel_mode="ref",
                                    deadline_rounds=deadline),
            J.EngineParams.lossless(JSP(L=L, W=1, k=K_RES), SLOTS, DEG,
                                    spec_width=spec, kernel_mode="jnp",
                                    deadline_rounds=deadline))


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=what)


def _same_state(port, ref, what):
    """Every port field equals the reference's (the bloom as its uint32
    words)."""
    for name in P.EngineState._fields:
        a, b = getattr(port, name), getattr(ref, name)
        if name == "bloom":
            a, b = bloom_pack(a), np.asarray(b).astype(np.int64)
        _eq(a, b, f"{what}: {name}")


def _spec_state(spec, shape=(S, SLOTS)):
    w = np.full(shape, spec, np.int32)
    z = np.zeros(shape, np.float32)
    m1 = np.full(shape, -1.0, np.float32)
    arrs = (w, m1, z, m1, z)
    return (tuple(torch.as_tensor(x) for x in arrs),
            tuple(jnp.asarray(x) for x in arrs))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("page_w", [0.0, 0.5])
def test_spec_update_bits_match_reference(page_w, seed):
    """Random controller states (first rounds, EMA updates, idle rows,
    pages deltas of 0) through one step: every output bit equal."""
    rng = np.random.default_rng(seed)
    shape, spec_max = (4, 64), 8
    sw = rng.integers(0, spec_max + 1, shape).astype(np.int32)
    hit = np.where(rng.random(shape) < 0.3, -1.0,
                   rng.random(shape)).astype(np.float32)
    peak = np.maximum(hit, rng.random(shape)).astype(np.float32)
    phit = np.where(rng.random(shape) < 0.3, -1.0,
                    rng.random(shape) * 4).astype(np.float32)
    ppeak = np.maximum(phit, rng.random(shape) * 4).astype(np.float32)
    accepted = rng.integers(0, 30, shape).astype(np.int32)
    worked = rng.random(shape) < 0.8
    pages = rng.integers(0, 20, shape[0]).astype(np.int32)
    cfg = JSpecController(spec_max=spec_max, W=2, max_degree=DEG,
                          page_w=page_w).cfg
    for pd in (pages, None):
        want = J.spec_update(
            jnp.asarray(sw), jnp.asarray(hit), jnp.asarray(peak),
            jnp.asarray(accepted), jnp.asarray(worked), cfg,
            None if pd is None else jnp.asarray(pd), jnp.asarray(phit),
            jnp.asarray(ppeak))
        got = P.spec_update(
            torch.as_tensor(sw), torch.as_tensor(hit), torch.as_tensor(peak),
            torch.as_tensor(accepted), torch.as_tensor(worked), cfg,
            None if pd is None else torch.as_tensor(pd),
            torch.as_tensor(phit), torch.as_tensor(ppeak))
        for a, b, name in zip(got, want, ("spec_w", "hit", "peak", "phit",
                                          "ppeak")):
            assert a.dtype == (torch.int32 if name == "spec_w"
                               else torch.float32)
            _eq(a.view(torch.int32), np.asarray(b).view(np.int32), name)


@pytest.mark.parametrize("spec,deadline", [(0, 0), (4, 0), (4, 3)])
def test_state_after_interleaved_rounds_and_admits(ds, spec, deadline):
    queries, (pc, pg, pe), (jc, jg, je) = ds
    pp, jp = _params(spec, deadline)
    q0 = queries[:S * SLOTS].reshape(S, SLOTS, -1)
    q1 = queries[S * SLOTS:2 * S * SLOTS].reshape(S, SLOTS, -1)
    pq, jq = torch.as_tensor(q0), jnp.asarray(q0)
    ps = P.engine_init(pc, pq, *pe, pp, pg)
    js = J.engine_init(jc, jq, *je, params=jp, geom=jg)
    _same_state(ps, js, "init")
    rng = np.random.default_rng(spec + deadline)
    for r in range(6):
        sw = rng.integers(0, spec + 1, (S, SLOTS)).astype(np.int32)
        ps = P.engine_round(pc, ps, pq, torch.as_tensor(sw), pp, pg)
        js = J.engine_round(jc, js, jq, jnp.asarray(sw), params=jp, geom=jg)
        _same_state(ps, js, f"round {r}")
        if r % 2:
            m = rng.random((S, SLOTS)) < 0.5
            ps, pq = P.engine_admit(ps, pq, torch.as_tensor(m),
                                    torch.as_tensor(q1), *pe, pp, pg)
            js, jq = J.engine_admit(js, jq, jnp.asarray(m), jnp.asarray(q1),
                                    *je, params=jp, geom=jg)
            _same_state(ps, js, f"admit {r}")
            _eq(pq, jq, "query buffer")
    # a scalar width broadcasts like the reference's
    _same_state(P.engine_round(pc, ps, pq, spec, pp, pg),
                J.engine_round(jc, js, jq, spec, params=jp, geom=jg),
                "scalar width")


@pytest.mark.parametrize("dynamic", [False, True])
@pytest.mark.parametrize("deadline", [0, 3])
def test_run_chunk_matches_reference(ds, dynamic, deadline):
    """Consecutive chunks (full budget, budget cut with stop-on-finish,
    a smaller K) carry the state across: state, controller, steps and
    the live/width traces equal."""
    queries, (pc, pg, pe), (jc, jg, je) = ds
    pp, jp = _params(4, deadline)
    q0 = queries[:S * SLOTS].reshape(S, SLOTS, -1)
    ps = P.engine_init(pc, torch.as_tensor(q0), *pe, pp, pg)
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    cfg = (JSpecController(spec_max=4, W=1, max_degree=DEG, page_w=0.5).cfg
           if dynamic else J_NULL_CFG)
    pspec, jspec = _spec_state(4)
    for K, budget, stop in ((8, 8, False), (8, 5, True), (4, 4, False),
                            (8, 8, True)):
        got = P.engine_run_chunk(pc, ps, torch.as_tensor(q0), pspec, cfg,
                                 budget, stop, pp, pg, K, dynamic)
        want = J.engine_run_chunk(jc, js, jnp.asarray(q0), jspec, cfg,
                                  budget, stop, params=jp, geom=jg, K=K,
                                  dynamic=dynamic)
        _same_state(got[0], want[0], f"chunk K={K}")
        for a, b in zip(got[1], want[1]):
            _eq(a, b, "controller")
        assert int(got[2]) == int(want[2])
        _eq(got[3], want[3], "live_cnt")
        _eq(got[4], want[4], "width_sum")
        # the reference's outputs: steps is a device scalar, read by the
        # caller with the chunk boundary's transfer
        assert len(got) == len(want) and got[2].dim() == 0
        ps, js, pspec, jspec = got[0], want[0], got[1], want[1]


@pytest.mark.parametrize("spec,dynamic,deadline",
                         [(0, False, 0), (4, False, 0), (4, True, 0),
                          (4, True, 3)])
def test_run_chunk_admit_matches_reference(ds, spec, dynamic, deadline):
    """Consecutive admission chunks over a parked pool and a staged
    queue of 32 arrivals, until a chunk finds nothing to do: state,
    query buffer, controller, steps, every trace (live, widths, admit
    indices, the evicted rows' results, rounds, n_dist, age, truncated)
    and the cursor equal."""
    queries, (pc, pg, pe), (jc, jg, je) = ds
    pp, jp = _params(spec, deadline)
    q0 = np.zeros((S, SLOTS, queries.shape[1]), np.float32)
    ps = P.engine_init(pc, torch.as_tensor(q0), *pe, pp, pg)
    ps = ps._replace(done=torch.ones_like(ps.done))
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    js = js._replace(done=jnp.ones(js.done.shape, bool))
    pq, jq = torch.as_tensor(q0), jnp.asarray(q0)
    cfg = (JSpecController(spec_max=spec, W=1, max_degree=DEG).cfg
           if dynamic else J_NULL_CFG)
    pspec, jspec = _spec_state(spec)
    arr = np.sort(np.random.default_rng(1).integers(0, 10, len(queries)))
    ppend = (torch.as_tensor(queries), torch.as_tensor(arr.astype(np.int32)))
    jpend = (jnp.asarray(queries), jnp.asarray(arr, jnp.int32))
    pcur = jcur = t = 0
    names = ("live_cnt", "width_sum", "admit_qidx", "ret_i", "ret_d",
             "ret_rounds", "ret_ndist", "ret_age", "ret_trunc", "cursor")
    for _ in range(40):
        got = P.engine_run_chunk_admit(pc, ps, pq, pspec, cfg, 8, *ppend,
                                       pcur, t, *pe, pp, pg, 8, dynamic)
        want = J.engine_run_chunk_admit(jc, js, jq, jspec, cfg, 8, *jpend,
                                        jcur, t, *je, params=jp, geom=jg,
                                        K=8, dynamic=dynamic)
        _same_state(got[0], want[0], f"round {t}")
        _eq(got[1], want[1], "query buffer")
        for a, b in zip(got[2], want[2]):
            _eq(a, b, "controller")
        assert int(got[3]) == int(want[3])
        for a, b, name in zip(got[4:14], want[4:14], names):
            _eq(a, b, name)
        ps, pq, pspec, pcur = got[0], got[1], got[2], got[13]
        js, jq, jspec, jcur = want[0], want[1], want[2], want[13]
        t += int(got[3])
        if int(got[3]) == 0:
            break
    assert int(pcur) == len(queries) and bool(ps.done.all())


def _shard_entries(pc, jc):
    """Per-shard entries: vertex s * 32 (shard s's first slot on the
    striped index) seeds shard s's rows, as build_routed_index's shard
    medoids seed routed legs."""
    ev = pc["db"][:, 0, 0].clone()
    en = (ev * ev).sum(-1)
    eid = torch.arange(S, dtype=torch.int32) * 32
    return ((ev, en, eid),
            (jnp.asarray(ev.numpy()), jnp.asarray(en.numpy()),
             jnp.asarray(eid.numpy())))


def _local(pp, jp):
    return (dataclasses.replace(pp, local_only=True),
            dataclasses.replace(jp, local_only=True))


@pytest.mark.parametrize("local_only", [False, True])
def test_per_shard_entries_and_local_rounds_match_reference(ds, local_only):
    """engine_init and engine_admit with per-shard entries, then rounds
    (with ``local_only``: proposals owned by other shards dropped):
    every state field equal; the routed stepper is the sim stepper."""
    queries, (pc, pg, _), (jc, jg, _) = ds
    pp, jp = _params(spec=4)
    if local_only:
        pp, jp = _local(pp, jp)
    pe, je = _shard_entries(pc, jc)
    stepper = P.make_stepper(pp, pg, routed=True)
    q0 = queries[:S * SLOTS].reshape(S, SLOTS, -1)
    ps = stepper.init(pc, torch.as_tensor(q0), *pe)
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    _same_state(ps, js, "init")
    pq, jq = torch.as_tensor(q0), jnp.asarray(q0)
    mask = np.zeros((S, SLOTS), bool)
    mask[1, 0] = mask[3, 1] = True
    new = queries[S * SLOTS:2 * S * SLOTS].reshape(S, SLOTS, -1)
    for r in range(6):
        ps = stepper.round(pc, ps, pq, 4)
        js = J.engine_round(jc, js, jq, 4, params=jp, geom=jg)
        _same_state(ps, js, f"round {r}")
        if r == 2:
            ps, pq = stepper.admit(ps, pq, torch.as_tensor(mask),
                                   torch.as_tensor(new), *pe)
            js, jq = J.engine_admit(js, jq, jnp.asarray(mask),
                                    jnp.asarray(new), *je, params=jp,
                                    geom=jg)
            _same_state(ps, js, "admit")
            _eq(pq, jq, "query buffer")


@pytest.mark.parametrize("local_only,dynamic", [(False, False),
                                                (True, False), (True, True)])
def test_run_chunk_admit_per_shard_queues_matches_reference(ds, local_only,
                                                            dynamic):
    """Routed admission chunks: per-shard pending queues ((S, Np),
    padded with INT32_MAX), per-shard cursors and entries, each shard
    seating its own queue from offset 0, until a chunk finds nothing to
    do: every output equal to the reference's, the cursors included."""
    queries, (pc, pg, _), (jc, jg, _) = ds
    spec = 4 if dynamic else 0
    pp, jp = _params(spec)
    if local_only:
        pp, jp = _local(pp, jp)
    pe, je = _shard_entries(pc, jc)
    rng = np.random.default_rng(2)
    tgt = rng.integers(0, S, len(queries))
    arr = np.sort(rng.integers(0, 12, len(queries)))
    npend = int(np.bincount(tgt, minlength=S).max())
    pend_q = np.zeros((S, npend, queries.shape[1]), np.float32)
    pend_a = np.full((S, npend), np.iinfo(np.int32).max, np.int32)
    for s in range(S):
        rows = np.flatnonzero(tgt == s)
        pend_q[s, :len(rows)] = queries[rows]
        pend_a[s, :len(rows)] = arr[rows]
    q0 = np.zeros((S, SLOTS, queries.shape[1]), np.float32)
    ps = P.engine_init(pc, torch.as_tensor(q0), *pe, pp, pg)
    ps = ps._replace(done=torch.ones_like(ps.done))
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    js = js._replace(done=jnp.ones(js.done.shape, bool))
    pq, jq = torch.as_tensor(q0), jnp.asarray(q0)
    cfg = (JSpecController(spec_max=spec, W=1, max_degree=DEG).cfg
           if dynamic else J_NULL_CFG)
    pspec, jspec = _spec_state(spec)
    ppend = (torch.as_tensor(pend_q), torch.as_tensor(pend_a))
    jpend = (jnp.asarray(pend_q), jnp.asarray(pend_a))
    pcur = np.zeros(S, np.int64)
    jcur = jnp.zeros(S, jnp.int32)
    t = 0
    names = ("live_cnt", "width_sum", "admit_qidx", "ret_i", "ret_d",
             "ret_rounds", "ret_ndist", "ret_age", "ret_trunc", "cursor")
    for _ in range(40):
        got = P.engine_run_chunk_admit(pc, ps, pq, pspec, cfg, 8, *ppend,
                                       pcur, t, *pe, pp, pg, 8, dynamic)
        want = J.engine_run_chunk_admit(jc, js, jq, jspec, cfg, 8, *jpend,
                                        jcur, t, *je, params=jp, geom=jg,
                                        K=8, dynamic=dynamic)
        _same_state(got[0], want[0], f"round {t}")
        _eq(got[1], want[1], "query buffer")
        for a, b in zip(got[2], want[2]):
            _eq(a, b, "controller")
        assert int(got[3]) == int(want[3])
        for a, b, name in zip(got[4:14], want[4:14], names):
            _eq(a, b, name)
        ps, pq, pspec, pcur = got[0], got[1], got[2], got[13].clone()
        js, jq, jspec, jcur = want[0], want[1], want[2], want[13]
        t += int(got[3])
        if int(got[3]) == 0:
            break
    assert pcur.tolist() == np.bincount(tgt, minlength=S).tolist()
    assert bool(ps.done.all())
