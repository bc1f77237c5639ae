"""The engine's static variants on the port, against the reference
package: twins of the seven tests of tests/test_engine.py (the sharded
engine against the single-shard traversal, the gather_vectors baseline,
refresh invariance, speculative prefetch, overflow drops, page-locality
stats, sequential striping, bf16 query payloads), then the port against
the reference (jnp mode) case by case on one integer-valued index: ids,
f32 dists and every count, bit for bit, for ``gather_vectors`` and for
``payload_bf16`` (integers in [-8, 8] are exact in bf16). On real-valued
data the bf16 payload stays within the reference test's tolerance of the
f32 path and within 0.01 recall@k of the reference's bf16 run."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.engine import search_sim as j_search_sim
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.core.scheduler import stream_search as j_stream_search
from repro.data.vectors import VectorDataset as JDataset
from repro_torch.core.engine import (EngineParams, exchange_buckets,
                                    pack_for_engine, search_sim)
from repro_torch.core.graph import (brute_force_topk, build_vamana,
                                    recall_at_k)
from repro_torch.core.luncsr import LUNCSR, Geometry, PackedIndex, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.refresh import refresh_blocks
from repro_torch.core.scheduler import stream_search
from repro_torch.core.traversal import search as traversal_search
from repro_torch.data.vectors import VectorDataset

CPU = dict(device="cpu")
STATS = ("rounds", "n_dist", "items_recv", "pages_unique", "drops_b",
         "props_sent", "total_rounds", "quarantined")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
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
    """tests/test_engine.py's integer index (n 1024, d 32, 4 shards, page
    32, degree 12, prefetch lists of 8), built by the reference; the
    port's host build gives the same arrays (tests/test_torch_launch.py).
    Also a cache of the reference's search_sim runs."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(1024, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(32, 32)).astype(np.float32)
    adj, medoid = j_vamana(db, r=12, alpha=1.2, seed=0)
    geo = JGeometry(num_shards=4, page_size=32, pages_per_block=2, dim=32)
    packed = j_pack_index(JLUNCSR.from_adjacency(
        db, adj, geo, entry=medoid, pref_width=8), max_degree=12)
    port_packed = as_port_index(packed)
    return dict(db=db, queries=queries, adj=adj, medoid=medoid,
                packed=packed, port_packed=port_packed,
                port=pack_for_engine(port_packed, **CPU),
                qsh=queries.reshape(4, 8, -1), ref={})


def _params(sp, qs, mode="ref", **kw):
    return EngineParams.lossless(SearchParams(**sp), qs, 12,
                                 kernel_mode=mode, **kw)


def _search(ds, params, port=None):
    consts, geom, entry = port or ds["port"]
    i, d, st = search_sim(consts, ds["qsh"], *entry, params, geom, **CPU)
    return i.numpy(), d.numpy(), {k: st[k].numpy() for k in STATS}


def _reference(ds, sp, **kw):
    """The reference's search_sim (jnp mode) on the same index, cached."""
    key = (tuple(sorted(sp.items())), tuple(sorted(kw.items())))
    if key not in ds["ref"]:
        consts, geom, entry = j_pack(ds["packed"])
        p = JParams.lossless(JSP(**sp), 8, 12, kernel_mode="jnp", **kw)
        i, d, st = j_search_sim(consts, jnp.asarray(ds["qsh"]), *entry, p,
                                geom)
        ds["ref"][key] = (np.asarray(i), np.asarray(d),
                          {k: np.asarray(st[k]) for k in STATS})
    return ds["ref"][key]


def _same(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32),
                                  want[1].view(np.int32))
    for k in STATS:
        np.testing.assert_array_equal(got[2][k], want[2][k], err_msg=k)


# ---------------------------------------------------------------------------
# Twins of tests/test_engine.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", ["ref", "torch"])
@pytest.mark.parametrize("W", [1, 2])
def test_engine_sim_matches_traversal_bitexact(ds, W, mode):
    sp = SearchParams(L=16, W=W, k=10)
    out_i, out_d, st = _search(ds, _params(dict(L=16, W=W, k=10), 8, mode))
    db = ds["db"]
    vnorm = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    ref_i, ref_d, ref_st = traversal_search(db, ds["adj"], vnorm,
                                            ds["queries"], ds["medoid"], sp,
                                            **CPU)
    np.testing.assert_array_equal(out_i.reshape(-1, 10), ref_i.numpy())
    np.testing.assert_array_equal(out_d.reshape(-1, 10), ref_d.numpy())
    np.testing.assert_array_equal(st["rounds"].reshape(-1),
                                  ref_st["rounds"].numpy())


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_engine_gather_vectors_baseline_same_results(ds, mode):
    """The baseline moves vectors instead of distances: the same output."""
    sp = dict(L=16, W=1, k=10)
    i1, d1, s1 = _search(ds, _params(sp, 8, mode))
    i2, d2, s2 = _search(ds, _params(sp, 8, mode, gather_vectors=True))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1.view(np.int32), d2.view(np.int32))
    for k in ("rounds", "n_dist", "items_recv", "pages_unique"):
        np.testing.assert_array_equal(s1[k], s2[k], err_msg=k)


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_engine_refresh_invariance(ds, mode):
    """Block refresh moves physical pages; results must not change."""
    sp = dict(L=16, W=1, k=10)
    params = _params(sp, 8, mode)
    i1, d1, _ = _search(ds, params)
    refreshed = refresh_blocks(ds["port_packed"], np.random.default_rng(42),
                               frac=0.5)
    assert not np.array_equal(refreshed.blk_perm, ds["port_packed"].blk_perm)
    i2, d2, _ = _search(ds, params, pack_for_engine(refreshed, **CPU))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(d1, d2)


def test_engine_speculative_prefetch(ds):
    """Speculation: fewer rounds, more distance computations (Fig. 17),
    and no worse recall."""
    sp = dict(L=16, W=1, k=10)
    i0, _, s0 = _search(ds, _params(sp, 8))
    i1, _, s1 = _search(ds, _params(sp, 8, spec_width=8))
    assert s1["rounds"].sum() < s0["rounds"].sum()
    assert s1["n_dist"].sum() > s0["n_dist"].sum()
    true_i, _ = brute_force_topk(ds["db"], ds["queries"], k=10)
    r0 = recall_at_k(i0.reshape(-1, 10), true_i)
    r1 = recall_at_k(i1.reshape(-1, 10), true_i)
    assert r1 >= r0 - 0.01, (r1, r0)


def test_engine_capacity_overflow_drops_counted(ds):
    tight = EngineParams(search=SearchParams(L=16, W=1, k=10), capacity_a=8,
                         capacity_b=8, kernel_mode="ref")
    i, _, st = _search(ds, tight)
    assert st["drops_b"].sum() > 0
    ids = i.reshape(-1, 10)
    assert ((ids >= -1) & (ids < ds["db"].shape[0])).all()
    true_i, _ = brute_force_topk(ds["db"], ds["queries"], k=10)
    assert recall_at_k(ids, true_i) >= 0.3


def test_engine_page_locality_stats(ds):
    """Dynamic allocating shares page reads: unique < items."""
    _, _, st = _search(ds, _params(dict(L=16, W=1, k=10), 8))
    items, uniq = int(st["items_recv"].sum()), int(st["pages_unique"].sum())
    assert 0 < uniq < items, (uniq, items)


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_engine_sequential_striping(ds, mode):
    """'sequential' placement (no multi-plane interleave) works."""
    db = ds["db"]
    geo = Geometry(num_shards=4, page_size=32, pages_per_block=2, dim=32,
                   stripe="sequential")
    packed = pack_index(LUNCSR.from_adjacency(db, ds["adj"], geo,
                                              entry=ds["medoid"]),
                        max_degree=12)
    out_i, _, _ = _search(ds, _params(dict(L=16, W=1, k=10), 8, mode),
                          pack_for_engine(packed, **CPU))
    vnorm = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    ref_i, _, _ = traversal_search(db, ds["adj"], vnorm, ds["queries"],
                                   ds["medoid"],
                                   SearchParams(L=16, W=1, k=10), **CPU)
    np.testing.assert_array_equal(out_i.reshape(-1, 10), ref_i.numpy())


@pytest.fixture(scope="module")
def real():
    """tests/test_engine.py::test_payload_bf16_near_exact's setup: real-
    valued, well-separated data, built by the port (its host build is the
    reference's, array for array) and by the reference."""
    ds = VectorDataset("pay", n=1024, dim=32, clusters=8, intrinsic=8)
    db = ds.materialize()
    q = ds.queries(16)
    assert np.array_equal(db, JDataset("pay", n=1024, dim=32, clusters=8,
                                       intrinsic=8).materialize())
    adj, medoid = build_vamana(db, r=8)
    geom = Geometry(num_shards=4, page_size=32, pages_per_block=4, dim=32)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geom, entry=medoid),
                        max_degree=8)
    jgeom = JGeometry(num_shards=4, page_size=32, pages_per_block=4, dim=32)
    jpacked = j_pack_index(JLUNCSR.from_adjacency(db, adj, jgeom,
                                                  entry=medoid), max_degree=8)
    return db, q, packed, jpacked


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_payload_bf16_near_exact(real, mode):
    """bf16 query payloads: distances within bf16 rounding of the f32
    path (the reference test's rtol 2e-2 / atol 2e-2), ids stable on
    well-separated data (agreement > 0.9), and recall@k within 0.01 of
    the reference's bf16 run."""
    db, q, packed, jpacked = real
    consts, geom, entry = pack_for_engine(packed, **CPU)
    qsh = q.reshape(4, 4, -1)
    base = EngineParams.lossless(SearchParams(L=16, W=1, k=5), 4, 8,
                                 kernel_mode=mode)
    bf = dataclasses.replace(base, payload_bf16=True)
    i0, d0, _ = search_sim(consts, qsh, *entry, base, geom, **CPU)
    i1, d1, _ = search_sim(consts, qsh, *entry, bf, geom, **CPU)
    np.testing.assert_allclose(d1.numpy(), d0.numpy(), rtol=2e-2, atol=2e-2)
    assert (i0 == i1).double().mean() > 0.9
    jconsts, jg, jentry = j_pack(jpacked)
    jbf = JParams.lossless(JSP(L=16, W=1, k=5), 4, 8, kernel_mode="jnp",
                           payload_bf16=True)
    ji, _, _ = j_search_sim(jconsts, jnp.asarray(qsh), *jentry, jbf, jg)
    true_i, _ = brute_force_topk(db, q, 5)
    got = recall_at_k(i1.numpy().reshape(-1, 5), true_i)
    want = recall_at_k(np.asarray(ji).reshape(-1, 5), true_i)
    assert abs(got - want) <= 0.01, (got, want)


# ---------------------------------------------------------------------------
# Port against reference, case by case, bit for bit (integer index)
# ---------------------------------------------------------------------------
VARIANTS = {
    "gather_vectors": dict(gather_vectors=True),
    "payload_bf16": dict(payload_bf16=True),
    "gather_vectors_spec4": dict(gather_vectors=True, spec_width=4),
    "payload_bf16_spec4": dict(payload_bf16=True, spec_width=4),
}


@pytest.mark.parametrize("qb", [0, 8])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("mode", ["ref", "torch"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_variant_bit_identical_to_reference(ds, variant, mode, W, qb):
    sp = dict(L=16, W=W, k=10)
    kw = VARIANTS[variant]
    got = _search(ds, _params(sp, 8, mode, coalesce_qb=qb, **kw))
    _same(got, _reference(ds, sp, **kw))
    # on integer data each variant's results are NDP's
    _same(got, _search(ds, _params(sp, 8, mode,
                                   spec_width=kw.get("spec_width", 0))))


@pytest.mark.parametrize("variant", ["gather_vectors", "payload_bf16"])
def test_stream_variant_bit_identical_to_reference(ds, variant):
    """The streaming scheduler's chunks step the same rounds: per-query
    records equal the reference's stream_search."""
    consts, geom, entry = ds["port"]
    kw = {variant: True}
    sp = dict(L=16, W=1, k=10)
    arrivals = np.random.default_rng(1).integers(0, 12, 32)
    ids, dists, st = stream_search(consts, geom, _params(sp, 3, **kw), entry,
                                   ds["queries"], num_slots=3,
                                   arrivals=arrivals, round_chunk=4, **CPU)
    jc, jg, je = j_pack(ds["packed"])
    jp = JParams.lossless(JSP(**sp), 3, 12, kernel_mode="jnp", **kw)
    wids, wdists, wst = j_stream_search(jc, jg, jp, je, ds["queries"],
                                        num_slots=3, arrivals=arrivals,
                                        round_chunk=4)
    np.testing.assert_array_equal(ids, np.asarray(wids))
    np.testing.assert_array_equal(dists.view(np.int32),
                                  np.asarray(wdists).view(np.int32))
    rec = {r.qid: (r.admit_round, r.retire_round, r.service_rounds,
                   r.n_dist) for r in st.results}
    assert rec == {r.qid: (r.admit_round, r.retire_round, r.service_rounds,
                           r.n_dist) for r in wst.results}
    assert (st.items_recv, st.pages_unique, st.total_rounds) == \
        (wst.items_recv, wst.pages_unique, wst.total_rounds)


def test_exchange_buckets_per_variant(ds):
    """The bucket bytes one round hands to the four exchanges: bf16
    payloads halve the query vectors phase C sends, and the baseline
    sends none of them and gets whole vectors back in phase D."""
    consts, geom, entry = ds["port"]
    sp, d = dict(L=16, W=1, k=10), geom.dim
    ex = {name: exchange_buckets(consts, ds["qsh"], *entry,
                                 _params(sp, 8, **kw), geom)
          for name, kw in (("ndp", {}), ("payload_bf16", {"payload_bf16":
                                                           True}),
                           ("gather_vectors", {"gather_vectors": True}))}
    S, p = geom.num_shards, _params(sp, 8)
    for e in ex.values():
        assert [x["slots"] for x in e] == [S * S * p.capacity_a] * 2 + \
            [S * S * p.capacity_b] * 2
        assert e[0] == ex["ndp"][0] and e[1] == ex["ndp"][1]
    slots = ex["ndp"][2]["slots"]
    assert ex["ndp"][2]["bytes"] - ex["payload_bf16"][2]["bytes"] == \
        slots * d * 2
    assert ex["payload_bf16"][3] == ex["ndp"][3]
    assert ex["ndp"][2]["bytes"] - ex["gather_vectors"][2]["bytes"] == \
        slots * (d * 4 + 4)                               # qvec, qq
    assert ex["gather_vectors"][3]["bytes"] - ex["ndp"][3]["bytes"] == \
        slots * d * 4                                     # vec, vn for dist
