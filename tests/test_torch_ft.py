"""Fault tolerance on the port against the reference package: the guard
primitives and the fault plans (twins of tests/test_ft_guard.py), the
corruption hash equal to the reference's on every page, and the five
flat-path fault tests of tests/test_scheduler.py on the port's
streaming scheduler; then port against reference on one integer index,
bit for bit, per query, under delay, kill and page-corruption plans,
guarded and unguarded."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.core.scheduler import stream_search as j_stream_search
from repro.ft import inject as jinject
from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import StreamScheduler, stream_search
from repro_torch.ft.guard import (NEG_GARBAGE, all_finite,
                                  quarantine_distances, select_tree)
from repro_torch.ft.inject import (NEVER, FaultSpec, bad_page_mask,
                                   corrupt_value, fault_plan,
                                   parse_fault_args, stall_at)
from repro_torch.utils import INVALID

FILL = 3.0e38
SLOTS, NQ = 2, 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# guard.all_finite / select_tree / quarantine_distances
# ---------------------------------------------------------------------------
def test_all_finite_ignores_int_and_bool_leaves():
    tree = {"step": torch.tensor(7, dtype=torch.int32),
            "mask": torch.ones(3, dtype=torch.bool),
            "idx": torch.arange(4, dtype=torch.int32)}
    assert bool(all_finite(tree))
    tree["grad"] = torch.tensor([1.0, float("nan")])
    assert not bool(all_finite(tree))
    assert bool(all_finite({"big": torch.full((2,), 2**31 - 1,
                                              dtype=torch.int32)}))


def test_all_finite_empty_tree():
    assert bool(all_finite({}))
    assert bool(all_finite([]))
    assert bool(all_finite({"only_ints": torch.zeros(2, dtype=torch.int32)}))


def test_all_finite_mixed_dtypes_all_checked():
    tree = {"a": torch.zeros((2, 2)),
            "b": torch.tensor([float("inf")], dtype=torch.float16)}
    assert not bool(all_finite(tree))


def test_select_tree_scalar_pred():
    a = {"x": torch.ones((2, 3)), "n": torch.tensor(1)}
    b = {"x": torch.zeros((2, 3)), "n": torch.tensor(2)}
    out_t = select_tree(torch.tensor(True), a, b)
    out_f = select_tree(torch.tensor(False), a, b)
    assert torch.equal(out_t["x"], a["x"]) and int(out_t["n"]) == 1
    assert torch.equal(out_f["x"], b["x"]) and int(out_f["n"]) == 2


def test_select_tree_array_pred_broadcasts():
    pred = torch.tensor([True, False])[:, None]
    out = select_tree(pred, [torch.ones((2, 3))], [torch.zeros((2, 3))])[0]
    np.testing.assert_array_equal(out.numpy(), [[1, 1, 1], [0, 0, 0]])


def test_quarantine_distances_rewrites_and_counts():
    dist = torch.tensor([0.5, float("nan"), float("inf"), -2.0e30, 1.0])
    clean, n = quarantine_distances(dist, torch.ones(5, dtype=torch.bool),
                                    FILL)
    assert int(n) == 3 and n.dtype == torch.int32
    np.testing.assert_array_equal(
        clean.numpy(), np.asarray([0.5, FILL, FILL, FILL, 1.0], np.float32))


def test_quarantine_distances_respects_valid_mask():
    dist = torch.tensor([float("nan"), float("nan")])
    clean, n = quarantine_distances(dist, torch.tensor([True, False]), FILL)
    assert int(n) == 1
    assert float(clean[0]) == np.float32(FILL) and np.isnan(float(clean[1]))


def test_quarantine_distances_identity_on_clean():
    dist = torch.linspace(0.0, 5.0, 8)
    clean, n = quarantine_distances(dist, torch.ones(8, dtype=torch.bool),
                                    FILL)
    assert int(n) == 0 and torch.equal(clean, dist)
    assert NEG_GARBAGE == -1.0e30


def test_quarantine_distances_per_shard_counts():
    """The shard-batched engine counts per shard (``dim``)."""
    dist = torch.tensor([[[float("nan"), 1.0]], [[-1e31, float("inf")]]])
    _, n = quarantine_distances(dist, torch.ones_like(dist, dtype=torch.bool),
                                FILL, dim=(1, 2))
    assert n.tolist() == [1, 2]


# ---------------------------------------------------------------------------
# inject.FaultSpec: plan building, validation, device evaluation
# ---------------------------------------------------------------------------
def test_fault_plan_builders_and_defaults():
    spec = fault_plan(4)
    assert spec.kill_round == (NEVER,) * 4
    assert not (spec.any_stall or spec.any_kill or spec.any_corrupt)
    spec = spec.kill(1, 10).delay(2, 3, 5).corrupt(0.1, "neg", seed=7)
    assert spec.kill_round == (NEVER, 10, NEVER, NEVER)
    assert spec.delay_from == (NEVER, NEVER, 3, NEVER)
    assert spec.delay_rounds == (0, 0, 5, 0)
    assert spec.any_stall and spec.any_kill and spec.any_corrupt
    # frozen, tuple-only fields: hashable, so each plan keys its capture
    assert hash(spec) == hash(dataclasses.replace(spec))
    np.testing.assert_array_equal(spec.down_at(9), [0, 0, 0, 0])
    np.testing.assert_array_equal(spec.down_at(10), [0, 1, 0, 0])
    want = jinject.fault_plan(4).kill(1, 10).delay(2, 3, 5).corrupt(
        0.1, "neg", seed=7)
    assert dataclasses.asdict(spec) == dataclasses.asdict(want)


def test_fault_spec_validation():
    with pytest.raises(ValueError, match="kill_round"):
        FaultSpec(num_shards=4, kill_round=(1, 2))
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultSpec(num_shards=2, corrupt_mode="zeros")
    with pytest.raises(ValueError, match="corrupt_rate"):
        FaultSpec(num_shards=2, corrupt_rate=1.5)


def test_stall_at_windows():
    spec = fault_plan(3).kill(0, 5).delay(1, 2, 3)
    jspec = jinject.fault_plan(3).kill(0, 5).delay(1, 2, 3)
    rows = np.stack([stall_at(spec, torch.tensor(t, dtype=torch.int32))
                     .numpy() for t in range(8)])
    np.testing.assert_array_equal(rows[:, 0], [0, 0, 0, 0, 0, 1, 1, 1])
    np.testing.assert_array_equal(rows[:, 1], [0, 0, 1, 1, 1, 0, 0, 0])
    assert not rows[:, 2].any()
    np.testing.assert_array_equal(
        rows, np.stack([np.asarray(jinject.stall_at(jspec, t))
                        for t in range(8)]))


def test_bad_page_mask_deterministic_rate():
    spec = fault_plan(4).corrupt(0.1, seed=3)
    pages = torch.arange(20000, dtype=torch.int32)
    m0 = bad_page_mask(spec, pages, 0).numpy()
    m1 = bad_page_mask(spec, pages, 1).numpy()
    np.testing.assert_array_equal(m0, bad_page_mask(spec, pages, 0).numpy())
    assert (m0 != m1).any()
    assert abs(m0.mean() - 0.1) < 0.02
    other = fault_plan(4).corrupt(0.1, seed=4)
    assert (bad_page_mask(other, pages, 0).numpy() != m0).any()
    assert np.isnan(corrupt_value(spec))
    assert corrupt_value(fault_plan(1).corrupt(0.5, "neg")) < NEG_GARBAGE


@pytest.mark.parametrize("rate", [0.01, 0.08, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 3, 2**31 + 5])
def test_bad_page_mask_equals_reference(rate, seed):
    """The uint32 hash carried in int64 equals the reference's mask on
    every page of shards 0-7, per shard, and on the shard-batched call
    the engine makes (``arange(S)[:, None]``)."""
    spec = fault_plan(8).corrupt(rate, seed=seed)
    jspec = jinject.fault_plan(8).corrupt(rate, seed=seed)
    pages = np.arange(0, 1 << 16, dtype=np.int32)
    want = np.stack([np.asarray(jinject.bad_page_mask(jspec, pages, s))
                     for s in range(8)])
    batched = bad_page_mask(spec, torch.as_tensor(pages)[None].expand(8, -1),
                            torch.arange(8)[:, None]).numpy()
    np.testing.assert_array_equal(batched, want)
    for s in range(8):
        np.testing.assert_array_equal(
            bad_page_mask(spec, torch.as_tensor(pages), s).numpy(), want[s])


def test_parse_fault_args():
    spec = parse_fault_args(4, kill=["1:10"], delay=["2:3:5"],
                            corrupt_rate=0.05, corrupt_mode="neg", seed=9)
    assert spec.kill_round[1] == 10
    assert spec.delay_from[2] == 3 and spec.delay_rounds[2] == 5
    assert spec.corrupt_rate == 0.05 and spec.seed == 9
    assert parse_fault_args(4) is None
    assert dataclasses.asdict(spec) == dataclasses.asdict(
        jinject.parse_fault_args(4, kill=["1:10"], delay=["2:3:5"],
                                 corrupt_rate=0.05, corrupt_mode="neg",
                                 seed=9))


# ---------------------------------------------------------------------------
# The flat-path fault tests of tests/test_scheduler.py, on the port
# ---------------------------------------------------------------------------
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
def ds():
    """tests/test_scheduler.py's integer index, built by the reference,
    packed for both packages."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(1024, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(32, 32)).astype(np.float32)
    adj, medoid = j_vamana(db, r=12, alpha=1.2, seed=0)
    geo = JGeometry(num_shards=4, page_size=32, pages_per_block=2, dim=32)
    packed = j_pack_index(JLUNCSR.from_adjacency(
        db, adj, geo, entry=medoid, pref_width=8), max_degree=12)
    return (queries[:NQ], pack_for_engine(_as_port_index(packed),
                                          device="cpu"), j_pack(packed))


SP = dict(L=16, W=1, k=10)


def _params(geom, mode="ref", **kw):
    return EngineParams.lossless(SearchParams(**SP), SLOTS, geom.max_degree,
                                 kernel_mode=mode, **kw)


def _serve(port, queries, params):
    consts, geom, entry = port
    return stream_search(consts, geom, params, entry, queries,
                         num_slots=SLOTS, round_chunk=8, device="cpu")


def test_fault_kill_shard_retires_all(ds):
    """Kill one shard mid-run (with a deadline): every query retires —
    rows on the dead shard age to the deadline and force-retire
    truncated; rows elsewhere finish clean and bit-exact."""
    queries, port, _ = ds
    geom = port[1]
    ref_i, _, ref_st = _serve(port, queries, _params(geom))
    dl = max(r.service_rounds for r in ref_st.results) + 4
    params = _params(geom, deadline_rounds=dl,
                     faults=fault_plan(geom.num_shards).kill(1, 4))
    _, _, st = _serve(port, queries, params)
    assert len(st.results) == NQ
    assert 0 < st.truncated < NQ
    for r in st.results:
        if r.truncated:
            assert r.retire_round - r.admit_round == dl
            assert r.service_rounds < dl
        else:
            np.testing.assert_array_equal(r.ids, ref_i[r.qid])


def test_fault_delay_is_transparent(ds):
    """A transient stall keeps traversal state: results are bit-identical
    to the healthy run; only stalled rows' latency grows."""
    queries, port, _ = ds
    geom = port[1]
    ref_i, ref_d, ref_st = _serve(port, queries, _params(geom))
    ids, dists, st = _serve(port, queries, _params(
        geom, faults=fault_plan(geom.num_shards).delay(0, 2, 5)))
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert st.truncated == 0
    lat = {r.qid: r.latency_rounds for r in st.results}
    ref_lat = {r.qid: r.latency_rounds for r in ref_st.results}
    assert all(lat[q] >= ref_lat[q] for q in lat)
    assert any(lat[q] > ref_lat[q] for q in lat)
    assert {r.qid: r.service_rounds for r in st.results} == \
        {r.qid: r.service_rounds for r in ref_st.results}
    assert st.stalls > 0


def test_fault_corruption_guard(ds):
    """Page corruption + guard: corrupt reads are quarantined and
    counted, outputs stay finite and non-negative; without the guard
    (the negative control) garbage reaches the results."""
    queries, port, _ = ds
    geom = port[1]
    faults = fault_plan(geom.num_shards).corrupt(0.08, "neg", seed=3)
    ids, dists, st = _serve(port, queries, _params(
        geom, faults=faults, guard_nonfinite=True))
    assert len(st.results) == NQ and st.quarantined > 0
    assert np.isfinite(dists[ids != INVALID]).all()
    assert (dists[ids != INVALID] >= 0).all()
    _, dists_u, st_u = _serve(port, queries, _params(geom, faults=faults))
    assert st_u.quarantined == 0
    assert (dists_u < 0).any()


def test_guard_identity_on_clean_data(ds):
    queries, port, _ = ds
    geom = port[1]
    ref_i, ref_d, base = _serve(port, queries, _params(geom))
    ids, dists, st = _serve(port, queries, _params(geom,
                                                   guard_nonfinite=True))
    np.testing.assert_array_equal(ids, ref_i)
    np.testing.assert_array_equal(dists, ref_d)
    assert st.quarantined == 0
    assert _records(st) == _records(base)


def test_fault_validation(ds):
    """A kill without a deadline, stalls without in-device admission and
    a plan sized for another pool are refused up front."""
    _, (consts, geom, entry), _ = ds
    S = geom.num_shards
    kill = fault_plan(S).kill(0, 5)
    with pytest.raises(ValueError, match="deadline"):
        StreamScheduler(consts, geom, _params(geom, faults=kill), entry,
                        num_slots=2, device="cpu")
    ok = _params(geom, faults=kill, deadline_rounds=8)
    with pytest.raises(ValueError, match="in-jit"):
        StreamScheduler(consts, geom, ok, entry, num_slots=2,
                        injit_admit=False, device="cpu")
    wrong = _params(geom, deadline_rounds=8,
                    faults=fault_plan(S + 1).kill(0, 5))
    with pytest.raises(ValueError, match="num_shards"):
        StreamScheduler(consts, geom, wrong, entry, num_slots=2,
                        device="cpu")


# ---------------------------------------------------------------------------
# Port against reference, per query, bit for bit
# ---------------------------------------------------------------------------
def _records(st):
    return {r.qid: (tuple(r.ids), tuple(np.asarray(r.dists).view(np.int32)),
                    r.latency_rounds, r.service_rounds, r.admit_round,
                    r.retire_round, bool(r.truncated), r.stall_rounds)
            for r in st.results}


PLANS = {
    "delay": (lambda f: f.delay(0, 2, 5).delay(3, 4, 2), {}),
    "kill": (lambda f: f.kill(1, 4), {"deadline_rounds": 12}),
    "corrupt_neg_guarded": (lambda f: f.corrupt(0.08, "neg", seed=3),
                            {"guard_nonfinite": True}),
    "corrupt_neg_unguarded": (lambda f: f.corrupt(0.08, "neg", seed=3), {}),
    "kill_delay_corrupt_guarded": (
        lambda f: f.kill(2, 6).delay(0, 1, 3).corrupt(0.2, "neg", seed=1),
        {"deadline_rounds": 10, "guard_nonfinite": True}),
}


@pytest.mark.parametrize("mode", ["ref", "torch"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_fault_plans_bit_identical_to_reference(ds, plan, mode):
    """Per-query ids, dists (by their bits), latency, service rounds,
    admission and retirement rounds, truncation and stall rounds, and
    the session's quarantined count, truncations, stalls and rounds,
    equal the reference's (jnp mode) on the integer index."""
    queries, port, (jconsts, jgeom, jentry) = ds
    build, kw = PLANS[plan]
    S = port[1].num_shards
    params = _params(port[1], mode, faults=build(fault_plan(S)), **kw)
    jparams = dataclasses.replace(
        JParams.lossless(JSP(**SP), SLOTS, jgeom.max_degree,
                         kernel_mode="jnp"),
        faults=build(jinject.fault_plan(S)), **kw)
    ids, dists, st = _serve(port, queries, params)
    wids, wdists, wst = j_stream_search(jconsts, jgeom, jparams, jentry,
                                        queries, num_slots=SLOTS,
                                        round_chunk=8)
    np.testing.assert_array_equal(ids, np.asarray(wids))
    np.testing.assert_array_equal(dists.view(np.int32),
                                  np.asarray(wdists).view(np.int32))
    assert _records(st) == _records(wst)
    for key in ("quarantined", "truncated", "stalls", "total_rounds",
                "items_recv", "pages_unique", "props_sent"):
        assert getattr(st, key) == getattr(wst, key), key
    if "corrupt" in plan and "unguarded" not in plan:
        assert st.quarantined > 0


def test_unguarded_nan_corruption(ds):
    """NaN corruption without the guard: nothing hangs and garbage
    reaches the results (every query's ids move off the healthy run's),
    as the reference asserts. Where the NaNs land, beside the
    reference's: the port's merges (``torch.sort`` in torch mode, the
    plain bitonic network in ref mode) order a NaN distance after every
    number, as ``lax.sort`` does, so no NaN reaches a top-k and the
    port's ids and dists equal the reference's bit for bit."""
    queries, port, (jconsts, jgeom, jentry) = ds
    S = port[1].num_shards
    faults = fault_plan(S).corrupt(0.2, "nan", seed=3)
    clean_i, _, _ = _serve(port, queries, _params(port[1]))
    jparams = dataclasses.replace(
        JParams.lossless(JSP(**SP), SLOTS, jgeom.max_degree,
                         kernel_mode="jnp"),
        faults=jinject.fault_plan(S).corrupt(0.2, "nan", seed=3))
    wids, wdists, _ = j_stream_search(jconsts, jgeom, jparams, jentry,
                                      queries, num_slots=SLOTS,
                                      round_chunk=8)
    for mode in ("ref", "torch"):
        ids, dists, st = _serve(port, queries, _params(port[1], mode,
                                                       faults=faults))
        assert len(st.results) == NQ and st.quarantined == 0
        assert (ids != clean_i).any(1).all()
        assert not np.isnan(dists).any()
        np.testing.assert_array_equal(ids, np.asarray(wids))
        np.testing.assert_array_equal(dists.view(np.int32),
                                      np.asarray(wdists).view(np.int32))
