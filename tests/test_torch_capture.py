"""The port's device-paced round loop vs the reference's ``lax.while_loop``
(jnp mode), bit for bit on one integer-valued index (n 1024, d 32, 4
shards, page 32, prefetch lists of 8): the fixed-K predicated chunks of
``engine_run_chunk`` and ``engine_run_chunk_admit`` and the chunked
``search_sim`` over a grid of K, budgets, stop-on-finish, static and
dynamic speculation, deadlines, a round cap reached inside a chunk, a
pool with every row done at entry and a queue with nothing arrived; and
the capture cache: one entry per session's chunk program, whose buffers
the next call overwrites. On the CPU a chunk runs eagerly through the
same cache entries a card replays as CUDA graphs."""
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
from repro_torch.core.capture import CACHE, CaptureCache
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import stream_search
from repro_torch.utils import bloom_pack

S, SLOTS, L, K_RES, DEG = 4, 2, 16, 10, 12
STATS = ("rounds", "n_dist", "items_recv", "pages_unique", "drops_b",
         "props_sent", "truncated", "total_rounds")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small torch ops on integer data: one intra-op thread, so
    parallel test workers do not oversubscribe the cores (integer
    arithmetic is exact at any thread count)."""
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


def _index(n=1024, d=32, nq=32, shards=S, page=32, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    adj, medoid = build_vamana(db, r=DEG, alpha=1.2, seed=seed)
    geo = Geometry(num_shards=shards, page_size=page, pages_per_block=2,
                   dim=d)
    return queries, pack_index(LUNCSR.from_adjacency(
        db, adj, geo, entry=medoid, pref_width=8), max_degree=DEG)


@pytest.fixture(scope="module")
def ds():
    queries, packed = _index()
    return (queries, P.pack_for_engine(as_port_index(packed), device="cpu"),
            J.pack_for_engine(packed))


def _params(spec=0, deadline=0, max_rounds=0, slots=SLOTS):
    kw = dict(spec_width=spec, deadline_rounds=deadline)
    return (P.EngineParams.lossless(
                SearchParams(L=L, W=1, k=K_RES, max_rounds=max_rounds),
                slots, DEG, kernel_mode="ref", **kw),
            J.EngineParams.lossless(
                JSP(L=L, W=1, k=K_RES, max_rounds=max_rounds), slots, DEG,
                kernel_mode="jnp", **kw))


def _eq(a, b, what):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if a.dtype == np.float32:            # bit for bit
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=what)


def _same_state(port, ref, what):
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


def _cfg(dynamic, spec):
    return (JSpecController(spec_max=spec, W=1, max_degree=DEG,
                            page_w=0.5).cfg if dynamic else J_NULL_CFG)


# K, budget, stop_on_finish, dynamic, deadline, max_rounds
CHUNK_GRID = [
    (1, 1, False, False, 0, 0),
    (1, 1, True, True, 0, 0),
    (3, 3, False, True, 0, 0),
    (3, 2, True, False, 3, 0),       # budget < K, a deadline
    (8, 8, False, True, 3, 0),
    (8, 5, True, True, 0, 0),        # budget < K
    (8, 8, False, False, 0, 12),     # the round cap inside a chunk
    (8, 8, True, True, 0, 10),
]


@pytest.mark.parametrize("K,budget,stop,dynamic,deadline,max_rounds",
                         CHUNK_GRID)
def test_run_chunk_predicated_matches_reference(ds, K, budget, stop, dynamic,
                                                deadline, max_rounds):
    """Consecutive chunks until one finds every row done at entry
    (steps 0): state, controller, steps and both K-traces equal."""
    queries, (pc, pg, pe), (jc, jg, je) = ds
    pp, jp = _params(4, deadline, max_rounds)
    q0 = queries[:S * SLOTS].reshape(S, SLOTS, -1)
    ps = P.engine_init(pc, torch.as_tensor(q0), *pe, pp, pg)
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    cfg = _cfg(dynamic, 4)
    pspec, jspec = _spec_state(4)
    steps = []
    for _ in range(80):
        got = P.engine_run_chunk(pc, ps, torch.as_tensor(q0), pspec, cfg,
                                 budget, stop, pp, pg, K, dynamic)
        want = J.engine_run_chunk(jc, js, jnp.asarray(q0), jspec, cfg,
                                  budget, stop, params=jp, geom=jg, K=K,
                                  dynamic=dynamic)
        _same_state(got[0], want[0], f"chunk {len(steps)}")
        for a, b in zip(got[1], want[1]):
            _eq(a, b, "controller")
        _eq(got[2], want[2], "steps")
        _eq(got[3], want[3], "live_cnt")
        _eq(got[4], want[4], "width_sum")
        steps.append(int(got[2]))
        if steps[-1] == 0:
            break
        ps, js, pspec, jspec = got[0], want[0], got[1], want[1]
    assert steps[-1] == 0 and bool(ps.done.all())
    assert max(steps) <= min(budget, K)
    if max_rounds:
        assert int(ps.rounds.max()) == max_rounds


# K, budget, dynamic, deadline, max_rounds, arrivals (rounds of 32)
ADMIT_GRID = [
    (1, 1, False, 0, 0, "spread"),
    (3, 3, True, 0, 0, "spread"),
    (3, 2, True, 3, 0, "spread"),    # budget < K, a deadline
    (8, 8, False, 5, 0, "burst"),
    (8, 8, True, 0, 12, "spread"),   # the round cap inside a chunk
    (8, 5, False, 0, 0, "late"),     # nothing arrived at first: steps 0
]


def _arrivals(kind, n):
    rng = np.random.default_rng(1)
    if kind == "burst":
        return np.zeros(n, np.int64)
    if kind == "late":
        return np.sort(rng.integers(20, 40, n))
    return np.sort(rng.integers(0, 10, n))


@pytest.mark.parametrize("K,budget,dynamic,deadline,max_rounds,kind",
                         ADMIT_GRID)
def test_run_chunk_admit_predicated_matches_reference(
        ds, K, budget, dynamic, deadline, max_rounds, kind):
    """Consecutive admission chunks over a parked pool and a staged
    queue, jumping the clock to the next arrival when a chunk finds
    nothing to do: state, query buffer, controller, steps, every trace
    and the cursor equal."""
    queries, (pc, pg, pe), (jc, jg, je) = ds
    pp, jp = _params(4, deadline, max_rounds)
    q0 = np.zeros((S, SLOTS, queries.shape[1]), np.float32)
    ps = P.engine_init(pc, torch.as_tensor(q0), *pe, pp, pg)
    ps = ps._replace(done=torch.ones_like(ps.done))
    js = J.engine_init(jc, jnp.asarray(q0), *je, params=jp, geom=jg)
    js = js._replace(done=jnp.ones(js.done.shape, bool))
    pq, jq = torch.as_tensor(q0), jnp.asarray(q0)
    cfg = _cfg(dynamic, 4)
    pspec, jspec = _spec_state(4)
    arr = _arrivals(kind, len(queries))
    ppend = (torch.as_tensor(queries), torch.as_tensor(arr.astype(np.int32)))
    jpend = (jnp.asarray(queries), jnp.asarray(arr, jnp.int32))
    pcur = jcur = t = 0
    names = ("live_cnt", "width_sum", "admit_qidx", "ret_i", "ret_d",
             "ret_rounds", "ret_ndist", "ret_age", "ret_trunc", "cursor")
    idle = 0
    for _ in range(120):
        got = P.engine_run_chunk_admit(pc, ps, pq, pspec, cfg, budget,
                                       *ppend, pcur, t, *pe, pp, pg, K,
                                       dynamic)
        want = J.engine_run_chunk_admit(jc, js, jq, jspec, cfg, budget,
                                        *jpend, jcur, t, *je, params=jp,
                                        geom=jg, K=K, dynamic=dynamic)
        _same_state(got[0], want[0], f"round {t}")
        _eq(got[1], want[1], "query buffer")
        for a, b in zip(got[2], want[2]):
            _eq(a, b, "controller")
        _eq(got[3], want[3], "steps")
        for a, b, name in zip(got[4:14], want[4:14], names):
            _eq(a, b, name)
        ps, pq, pspec, pcur = got[0], got[1], got[2], got[13]
        js, jq, jspec, jcur = want[0], want[1], want[2], want[13]
        steps = int(got[3])
        if steps == 0:        # the pool is empty and nothing has arrived
            idle += 1
            if int(pcur) == len(queries):
                break
            t = max(t + 1, int(arr[int(pcur)]))
        t += steps
    assert int(pcur) == len(queries) and bool(ps.done.all())
    assert idle >= 1 + (kind == "late")


@pytest.mark.parametrize("K,max_rounds,spec", [(1, 0, 0), (3, 0, 4),
                                                (8, 0, 0), (8, 5, 4),
                                                (3, 7, 0)])
def test_search_sim_chunks_match_reference(ds, monkeypatch, K, max_rounds,
                                           spec):
    """search_sim in chunks of K predicated rounds (a round cap inside a
    chunk included) equals the reference's while_loop: ids, dists,
    every stat; one host read per chunk."""
    queries, (pc, pg, pe), (jc, jg, je) = ds
    monkeypatch.setattr(P, "SEARCH_CHUNK", K)
    pp, jp = _params(spec, max_rounds=max_rounds, slots=8)
    qsh = queries.reshape(S, 8, -1)
    ids, dists, st = P.search_sim(pc, qsh, *pe, pp, pg, device="cpu")
    wi, wd, wst = J.search_sim(jc, jnp.asarray(qsh), *je, jp, jg)
    _eq(ids, wi, "ids")
    _eq(dists, wd, "dists")
    for name in STATS:
        _eq(st[name], wst[name], name)
    rounds = int(wst["total_rounds"][0])
    assert st["host_syncs"] == -(-rounds // K)
    if max_rounds:
        assert rounds == max_rounds


def test_search_sim_results_outlive_the_cache_buffers(ds):
    """search_sim copies its results out of the chunk's buffers: a later
    search through the same cache entry leaves them as they were."""
    queries, (pc, pg, pe), _ = ds
    pp, _ = _params(slots=8)
    qsh = queries.reshape(S, 8, -1)
    first = P.search_sim(pc, qsh, *pe, pp, pg, device="cpu")
    kept = [first[0].clone(), first[1].clone(), first[2]["rounds"].clone()]
    CACHE.reset_stats()
    P.search_sim(pc, qsh[::-1].copy(), *pe, pp, pg, device="cpu")
    assert CACHE.stats.captures == 0 and CACHE.stats.replays > 0
    for a, b in zip(kept, (first[0], first[1], first[2]["rounds"])):
        assert torch.equal(a, b)


def test_cache_entry_buffers_are_fed_back():
    """An entry's outputs are its buffers, overwritten by the next call;
    operands copy into the static inputs; a key per shape."""
    cache = CaptureCache(max_entries=2)
    x = torch.arange(4.0)
    out1 = cache.run("f", lambda a: (a + 1,), ("k",), (x,), 1)
    held = out1[0]
    out2 = cache.run("f", lambda a: (a + 1,), ("k",), (out1[0],), 1)
    assert out2[0] is held and torch.equal(held, x + 2)
    assert cache.stats.captures == 1 and cache.stats.replays == 2
    assert cache.stats.rounds == 2
    cache.run("f", lambda a: (a + 1,), ("k",), (torch.ones(3),), 1)
    cache.run("g", lambda a: (a,), ("k",), (x,), 1)
    assert cache.count("f") == 1 and cache.count("g") == 1   # LRU of 2
    assert torch.equal(cache.run("f", lambda a: (a * 3,), ("k",), (x,), 1,
                                 capture=False)[0], x * 3)


def test_session_captures_stepper_exactly_once():
    """Twin of the reference's test_session_compiles_stepper_exactly_once:
    a staggered-arrival in-device-admission session builds exactly one
    capture-cache entry (in its warmup) — of engine_run_chunk_admit —
    however many chunks it runs, and replays it once per chunk."""
    # shapes unique to this test: the cache is process-wide
    queries, packed = _index(n=768, d=28, nq=20, shards=2, page=16, seed=5)
    consts, geom, entry = P.pack_for_engine(as_port_index(packed),
                                            device="cpu")
    params = P.EngineParams.lossless(SearchParams(L=12, W=1, k=8), 2,
                                     geom.max_degree, spec_width=4,
                                     kernel_mode="ref")
    arrivals = np.random.default_rng(7).integers(0, 12, queries.shape[0])
    CACHE.reset_stats()
    ids, dists, st = stream_search(
        consts, geom, params, entry, queries, num_slots=2,
        arrivals=arrivals, round_chunk=4, injit_admit=True, device="cpu")
    assert CACHE.stats.captures == 1
    assert next(reversed(CACHE.entries))[0] == "engine_run_chunk_admit"
    assert CACHE.stats.replays == st.host_dispatches + 1   # + the warmup
    assert st.host_syncs == st.host_dispatches > 1
    assert st.total_rounds > 4
    assert len(st.results) == queries.shape[0]
