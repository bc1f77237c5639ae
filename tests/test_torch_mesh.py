"""Multi-device search on the port against the sim driver and the
reference, on the CPU over ``gloo``: ``search_distributed`` and the mesh
stepper (``make_stepper(mesh=...)``, ``stream_search(mesh=)``,
``routed_stream_search(mesh=)``), twins of tests/multishard_check.py and
tests/test_backend_dispatch.py's one-device mesh.

The index is multishard_check's (n 2048, d 32, integer vectors in
[-8, 8], degree 12, 8 shards, page 32), built once here with the
reference's builder and handed to the ranks as a pickle. Each world
runs its ranks as processes of ``tests/torch_mesh_ranks.py`` (a file
rendezvous in a temporary directory, an explicit group timeout) while
this process runs the same sessions on the sim driver. Every rank must
return the sim's ids, dists, records and counters bit for bit, and the
sim must return the reference's: its ``search_sim``, ``stream_search``
and ``routed_stream_search`` (jnp, one device) on the same index,
queries, arrivals and parameters (the routed sessions on the
reference's routed build). World 8 runs multishard_check's four legs
and a routed session, worlds 4 and 2 (2 and 4 shards per rank) a
search, the in-device-admission stream and (world 4) a fault session;
world 1 runs in this process."""
import datetime
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_mesh_ranks as ranks
from repro.core import router as JR
from repro.core import scheduler as JS
from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.engine import search_distributed as j_search_distributed
from repro.core.engine import search_sim as j_search_sim
from repro.core.graph import build_vamana
from repro.core.luncsr import LUNCSR, Geometry, pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.ft.inject import fault_plan as j_fault_plan
from repro.launch.mesh import make_engine_mesh as j_make_engine_mesh
from repro_torch.core.capture import CACHE
from repro_torch.core.engine import (EngineParams, make_stepper,
                                     pack_for_engine, search_distributed,
                                     shard_consts)
from repro_torch.core.backend import KernelBackend
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.router import RoutedIndex, ShardRouter
from repro_torch.core.scheduler import StreamScheduler
from repro_torch.launch.mesh import EngineMesh, make_engine_mesh

REPO = Path(__file__).resolve().parents[1]
RANKS = Path(__file__).resolve().with_name("torch_mesh_ranks.py")
N, D, NQ, S = 2048, 32, 64, 8
CPU = dict(device="cpu")
# seconds a world's ranks may take (they run beside the sim sessions)
RANK_TIMEOUT = {8: 240, 4: 150, 2: 150}
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
SEARCH_STATS = ("rounds", "n_dist", "items_recv", "pages_unique",
                "drops_b", "props_sent", "truncated", "quarantined",
                "total_rounds", "host_syncs")
ROUTED_BUILD = dict(shards=S, page_size=32, r=12, centroids_per_shard=4,
                    seed=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
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


def as_port_routed(jri) -> RoutedIndex:
    """The reference's routed build in the port's types (the CPU, ref
    mode): both sides serve the same routed index."""
    router = ShardRouter(
        centroids=torch.as_tensor(np.array(jri.router.centroids)),
        cnorm=torch.as_tensor(np.array(jri.router.cnorm)),
        backend=KernelBackend(mode="ref"))
    return RoutedIndex(db=jri.db, packed=as_port_index(jri.packed),
                       router=router,
                       shard_entries=tuple(torch.as_tensor(np.array(x))
                                           for x in jri.shard_entries),
                       medoids=np.asarray(jri.medoids))


def _pack(db, adj, medoid, shards):
    geo = Geometry(num_shards=shards, page_size=32, pages_per_block=2,
                   dim=D)
    index = LUNCSR.from_adjacency(db, adj, geo, entry=medoid, pref_width=4)
    return pack_index(index, max_degree=12)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """multishard_check's data and graph: the reference's packed index
    at 8 shards and at 1, the arrivals, the reference's routed build at
    8 shards, and the pickle the ranks load."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(N, D)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(NQ, D)).astype(np.float32)
    adj, medoid = build_vamana(db, r=12, alpha=1.2, seed=0)
    packed = _pack(db, adj, medoid, S)
    jrouted = JR.build_routed_index(db, **ROUTED_BUILD)
    data = {"packed": as_port_index(packed), "queries": queries,
            "arrivals": np.random.default_rng(5).integers(0, 8, NQ),
            "routed": as_port_routed(jrouted)}
    path = tmp_path_factory.mktemp("mesh") / "index.pkl"
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return {"jrouted": jrouted, "jpacked": packed,
            "packed1": _pack(db, adj, medoid, 1), "path": path,
            "data": ranks.load(path)}


def _j_session(st) -> dict:
    """A reference session as :func:`torch_mesh_ranks.run_case` keeps
    the port's: the records, and the counters both schedulers have."""
    fields = tuple(f for f in ranks.SUMMARY if f not in ranks.PORT_ONLY)
    return {"records": ranks.records(st),
            "summary": ranks.summary(st, fields)}


@pytest.fixture(scope="module")
def reference(built):
    """The reference's results for every search and session the worlds
    run (torch_mesh_ranks.CASES), by run_case's keys: ``search_sim``,
    ``stream_search`` and ``routed_stream_search`` in jnp mode (ref for
    the ref-mode search) on one device."""
    data = built["data"]
    queries, arrivals = data["queries"], data["arrivals"]
    consts, geom, entry = j_pack(built["jpacked"])
    out = {}
    for spec, mode in ranks.SEARCH:
        p = JParams.lossless(JSP(L=16, W=2, k=10), NQ // S, geom.max_degree,
                             spec_width=spec,
                             kernel_mode="jnp" if mode == "torch" else mode)
        i, d, st = j_search_sim(consts, jnp.asarray(
            queries.reshape(S, NQ // S, D)), *entry, p, geom)
        out[("search", spec, mode)] = {
            "ids": np.asarray(i), "dists": np.asarray(d).view(np.int32),
            **{k: np.asarray(v) for k, v in st.items()}}
    sp = JSP(L=16, W=2, k=10)
    params = JParams.lossless(sp, ranks.SLOTS, geom.max_degree, spec_width=4)
    kw = dict(num_slots=ranks.SLOTS, arrivals=arrivals)
    for dyn, chunk, injit in ranks.STREAMS:
        out[("stream", dyn, chunk, injit)] = _j_session(JS.stream_search(
            consts, geom, params, entry, queries, dynamic_spec=dyn,
            round_chunk=chunk, injit_admit=injit, **kw)[2])
    # torch_mesh_ranks.fault_params, in the reference's terms
    faults = j_fault_plan(S).kill(3, 6).delay(6, 2, 4).corrupt(
        0.08, "nan", seed=3)
    fparams = JParams.lossless(sp, ranks.SLOTS, geom.max_degree,
                               spec_width=4, guard_nonfinite=True,
                               faults=faults,
                               deadline_rounds=ranks.DEADLINE)
    out[("faults",)] = _j_session(JS.stream_search(
        consts, geom, fparams, entry, queries, round_chunk=4,
        injit_admit=True, **kw)[2])
    jri = built["jrouted"]
    rconsts, rgeom, rentry = j_pack(jri.packed)
    rparams = JParams.lossless(sp, ranks.SLOTS, rgeom.max_degree)
    out[("routed",)] = _j_session(JS.routed_stream_search(
        rconsts, rgeom, rparams, rentry, queries, router=jri.router, topr=2,
        round_chunk=4, injit_admit=True, shard_entries=jri.shard_entries,
        **kw)[2])
    return out


def _mesh_case(built, tmp_path_factory, case: str, world: int) -> dict:
    """Run CASE on WORLD gloo ranks (processes) and on the sim driver
    here, at the same time; returns the ranks' results and the sim's."""
    out = tmp_path_factory.mktemp(case)
    (out / "index.pkl").symlink_to(built["path"])
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(world):
        logs.append(open(out / f"rank{r}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, str(RANKS), case, str(r), str(world), str(out)],
            cwd=REPO, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        want = ranks.run_case(case, built["data"], None)
        deadline = time.monotonic() + RANK_TIMEOUT[world]
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, "\n".join((out / f"rank{r}.log").read_text()[-3000:]
                              for r in bad)
    got = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    return {"ranks": got, "sim": want}


@pytest.fixture(scope="module")
def w8(built, tmp_path_factory):
    return _mesh_case(built, tmp_path_factory, "w8", 8)


@pytest.fixture(scope="module")
def w4(built, tmp_path_factory):
    return _mesh_case(built, tmp_path_factory, "w4", 4)


@pytest.fixture(scope="module")
def w2(built, tmp_path_factory):
    return _mesh_case(built, tmp_path_factory, "w2", 2)


def _same(got, want, what):
    """Bit equality of nested results (arrays, dicts, lists, scalars)."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _same(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif isinstance(want, list) and want and \
            isinstance(want[0], np.ndarray):
        assert len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _same(a, b, f"{what}[{i}]")
    else:
        assert got == want, what


def _check_ranks(run, key, reference):
    """Every rank returns the sim's result for ``key``, and the sim the
    reference's (every field the reference has)."""
    for r, res in enumerate(run["ranks"]):
        _same(res[key], run["sim"][key], f"rank {r} {key}")
    want, got = reference[key], run["sim"][key]
    if "records" in want:
        _same(got["records"], want["records"], f"reference {key} records")
        got = {k: v for k, v in got["summary"].items()
               if k not in ranks.PORT_ONLY}
        want = want["summary"]
    else:
        assert {"rounds", "n_dist", "pages_unique", "items_recv",
                "total_rounds"} <= set(want), sorted(want)
        got = {k: got[k] for k in want}
    _same(got, want, f"reference {key}")
    return run["sim"][key]


# ---------------------------------------------------------------------------
# world 8: multishard_check's four legs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec,mode", ranks.SEARCH)
def test_search_distributed_world8_equals_sim_and_reference(w8, reference,
                                                            spec, mode):
    """search_distributed == the port's search_sim (every stat, the
    syncs) == the reference's search_sim (jnp for torch mode)."""
    got = _check_ranks(w8, ("search", spec, mode), reference)
    assert set(SEARCH_STATS) <= set(got)
    assert got["total_rounds"].shape == (S,)


@pytest.mark.parametrize("dyn", [False, True])
def test_mesh_stream_world8_equals_sim_and_oneshot(w8, reference, dyn):
    """The default streaming path (in-device admission, chunk 1) on the
    mesh stepper == the sim session == the reference's; with the
    controller off, == the one-shot search per query."""
    got = _check_ranks(w8, ("stream", dyn, 1, None), reference)
    assert len(got["records"]) == NQ
    if not dyn:
        shot = w8["sim"][("search", 4, "torch")]
        ids = shot["ids"].reshape(NQ, -1)
        dists = shot["dists"].reshape(NQ, -1)
        for q, rec in got["records"].items():
            assert rec[0] == tuple(ids[q]) and rec[1] == tuple(dists[q]), q


@pytest.mark.parametrize("dyn", [False, True])
def test_mesh_round_chunk_world8(w8, reference, dyn):
    """Chunk 4 == chunk 1 on the mesh (host admission): records,
    rounds, traces, with fewer dispatches; both == the sim sessions ==
    the reference's."""
    one = _check_ranks(w8, ("stream", dyn, 1, False), reference)
    four = _check_ranks(w8, ("stream", dyn, 4, False), reference)
    assert four["records"] == one["records"]
    for k in ("total_rounds", "occupancy_trace", "spec_trace"):
        assert four["summary"][k] == one["summary"][k], k
    assert four["summary"]["host_dispatches"] < \
        one["summary"]["host_dispatches"]


@pytest.mark.parametrize("dyn", [False, True])
def test_mesh_injit_admission_world8(w8, reference, dyn):
    """In-device admission (the all-gathered free ranks) == host
    admission at chunk 4 on the mesh, with fewer dispatches; both == the
    sim sessions == the reference's."""
    host = _check_ranks(w8, ("stream", dyn, 4, False), reference)
    dev = _check_ranks(w8, ("stream", dyn, 4, True), reference)
    assert dev["records"] == host["records"]
    for k in ("total_rounds", "occupancy_trace", "spec_trace",
              "idle_rounds"):
        assert dev["summary"][k] == host["summary"][k], k
    assert dev["summary"]["host_dispatches"] < \
        host["summary"]["host_dispatches"]


def test_routed_mesh_world8_equals_routed_sim(w8, reference):
    """A routed session (topr 2, per-shard queues seated in the device)
    on the mesh == the routed sim session == the reference's routed
    session, every record and counter."""
    got = _check_ranks(w8, ("routed",), reference)
    assert got["summary"]["legs"] == 2 * NQ


# ---------------------------------------------------------------------------
# worlds 4 and 2: several shards per rank
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("world", [4, 2])
def test_mesh_several_shards_per_rank(request, reference, world):
    """S_loc 2 and 4: search_distributed and the in-device-admission
    stream (free ranks offset across ranks) == the sim == the
    reference."""
    run = request.getfixturevalue(f"w{world}")
    _check_ranks(run, ("search", 4, "torch"), reference)
    _check_ranks(run, ("stream", False, 4, True), reference)


def test_faults_mesh_world4_equals_sim(w4, reference):
    """A kill under a deadline, a delay window and NaN corruption under
    the guard, at world 4 (shard 3 is rank 1's second row): == the sim
    session == the reference's, records and counters (truncated,
    stalls, quarantined)."""
    got = _check_ranks(w4, ("faults",), reference)
    summ = got["summary"]
    assert summ["truncated"] > 0 and summ["stalls"] > 0 and \
        summ["quarantined"] > 0, summ


# ---------------------------------------------------------------------------
# world 1, in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group1(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed after the
    module."""
    rdv = tmp_path_factory.mktemp("rdv1") / "rendezvous"
    dist.init_process_group("gloo", init_method=f"file://{rdv}", rank=0,
                            world_size=1, timeout=GROUP_TIMEOUT)
    try:
        yield make_engine_mesh(num=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode,jmode", [("torch", "jnp"), ("ref", "ref")])
def test_world1_equals_reference_search_distributed(built, group1, mode,
                                                    jmode):
    """One shard on a one-rank mesh == the reference's search_distributed
    on a one-device mesh (test_backend_dispatch.py's twin)."""
    packed = built["packed1"]
    queries = built["data"]["queries"][:16]
    qsh = queries[None]
    sp = JSP(L=16, W=2, k=10)
    jconsts, jgeom, jentry = j_pack(packed)
    jp = JParams.lossless(sp, 16, jgeom.max_degree, kernel_mode=jmode)
    ji, jd, jst = j_search_distributed(jconsts, jnp.asarray(qsh), *jentry,
                                       jp, jgeom, j_make_engine_mesh(num=1))
    consts, geom, entry = pack_for_engine(as_port_index(packed), **CPU)
    p = EngineParams.lossless(ranks.SP, 16, geom.max_degree,
                              kernel_mode=mode)
    i, d, st = search_distributed(consts, qsh, *entry, p, geom, group1,
                                  **CPU)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(d.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    for k in ("rounds", "n_dist", "pages_unique", "items_recv",
              "total_rounds"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]),
                                      err_msg=k)


def test_world1_make_stepper_matches_sim_stepper(built, group1):
    """Every stage of make_stepper(mesh=...) at world 1 over gloo == the
    sim stepper's on the same inputs; make_engine_mesh reads the
    group."""
    with pytest.raises(ValueError, match="num=3"):
        make_engine_mesh(num=3)
    assert (group1.rank, group1.world, group1.axis_name) == (0, 1, "lun")
    consts, geom, entry = built["data"]["engine"]
    params = EngineParams.lossless(ranks.SP, 2, geom.max_degree,
                                   spec_width=4)
    q = torch.as_tensor(built["data"]["queries"][:S * 2].reshape(S, 2, D))
    sim = make_stepper(params, geom, round_chunk=4)
    mesh = make_stepper(params, geom, mesh=group1, round_chunk=4)
    out = {}
    for name, st in (("sim", sim), ("mesh", mesh)):
        state = st.init(consts, q, *entry)
        state = st.round(consts, state, q, 4)
        mask = torch.zeros((S, 2), dtype=torch.bool)
        mask[::3, 1] = True
        state, qb = st.admit(state, q, mask, q.flip(0), *entry)
        w = torch.full((S, 2), 4, dtype=torch.int32)
        z = torch.zeros((S, 2))
        state, _, steps, lc, ws = st.run_chunk(
            consts, state, qb, (w, z, z, z, z), (4, 2, 12, 0.2, 0.6, 0.5),
            4, False)
        state = state._replace(done=state.done | torch.eye(
            S, 2, dtype=torch.bool))
        pend = (torch.as_tensor(built["data"]["queries"]),
                torch.arange(NQ, dtype=torch.int32))
        adm = st.run_chunk_admit(consts, state, qb, (w, z, z, z, z),
                                 (4, 2, 12, 0.2, 0.6, 0.5), 4, pend, 0, 3,
                                 entry)
        out[name] = (st.retire(adm[0]), adm[1:], (steps, lc, ws))
    _same(_flat(out["mesh"]), _flat(out["sim"]), "stepper")


def test_mesh_capture_key_holds_the_group(built, group1):
    """A chunk program keyed under one process group is not reused under
    another: two groups made one after the other (the first destroyed)
    over the same consts, params and shapes each build their own cache
    entry, and within a group the entry is reused."""
    consts, geom, entry = built["data"]["engine"]
    qsh = built["data"]["queries"][:S * 2].reshape(S, 2, D)
    params = EngineParams.lossless(ranks.SP, 2, geom.max_degree)
    out, gens = [], []
    for _ in range(2):
        group = dist.new_group([0])
        try:
            mesh = make_engine_mesh(group=group)
            gens.append(mesh.generation)
            for builds in (1, 0):
                CACHE.reset_stats()
                out.append(search_distributed(consts, qsh, *entry, params,
                                              geom, mesh, **CPU))
                assert CACHE.stats.captures == builds, (gens, builds)
        finally:
            dist.destroy_process_group(group)
    assert gens[0] != gens[1]
    for res in out[1:]:
        _same(_flat(res[:2]), _flat(out[0][:2]), "ids, dists")


def _flat(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree.numpy()]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    return [x for t in tree for x in _flat(t)]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("what", ["split", "live", "pagestore",
                                  "store_pages", "full_consts"])
def test_mesh_refusals(built, what):
    """A world that does not divide S; the live index and the tiered
    store with a mesh (the reference's ValueErrors); store_pages > 0 in
    search_distributed (the reference's NotImplementedError); every
    shard's consts where a rank's own are due (shard_consts). None
    reaches a collective."""
    consts, geom, entry = built["data"]["engine"]
    qsh = built["data"]["queries"].reshape(S, NQ // S, D)
    params = EngineParams.lossless(ranks.SP, NQ // S, geom.max_degree)
    one = EngineMesh(group=None, rank=0, world=1)
    if what == "split":
        three = EngineMesh(group=None, rank=1, world=3)
        for call in (lambda: shard_consts(consts, three),
                     lambda: search_distributed(consts, qsh, *entry, params,
                                                geom, three, **CPU),
                     lambda: make_stepper(params, geom, mesh=three)):
            with pytest.raises(ValueError, match="do not split"):
                call()
        assert EngineMesh(None, 1, 4).shard0(S) == 2
    elif what == "live":
        live = EngineParams.lossless(ranks.SP, 2, geom.max_degree,
                                     delta_cap=8)
        with pytest.raises(ValueError, match="the live index runs on the "
                           r"sim driver only \(mesh must be None\)"):
            StreamScheduler(consts, geom, live, entry, 2, mesh=one,
                            live=object(), **CPU)
    elif what == "pagestore":
        with pytest.raises(ValueError, match="mesh must be None"):
            StreamScheduler(consts, geom, params, entry, 2, mesh=one,
                            pagestore=object(), **CPU)
    elif what == "store_pages":
        tiered = EngineParams.lossless(ranks.SP, NQ // S, geom.max_degree,
                                       store_pages=4)
        with pytest.raises(NotImplementedError, match="tiered page store"):
            search_distributed(consts, qsh, *entry, tiered, geom, one,
                               **CPU)
    else:
        four = EngineMesh(group=None, rank=1, world=4)
        q = torch.as_tensor(qsh)
        state = make_stepper(params, geom).init(consts, q, *entry)
        stepper = make_stepper(params, geom, mesh=four)
        for call in (lambda: search_distributed(consts, qsh, *entry, params,
                                                geom, four, **CPU),
                     lambda: stepper.round(consts, state, q, 0),
                     lambda: StreamScheduler(consts, geom, params, entry, 2,
                                             mesh=four, **CPU)):
            with pytest.raises(ValueError, match="rank 1 of 4 owns 2"):
                call()
        mine = shard_consts(consts, four)
        assert mine["db"].shape[0] == 2
        torch.testing.assert_close(mine["adj"], consts["adj"][2:4],
                                   rtol=0, atol=0)
        assert shard_consts(consts, one) is consts
