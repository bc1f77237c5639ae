"""Port ``search_sim`` vs the reference ``search_sim`` (jnp mode) on one
integer-valued packed index: ids, dists and every per-query and
per-shard stat bit for bit, across modes, W, speculation width and
coalescing width. The index crosses packages as plain arrays
(``PackedIndex.from_arrays``)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.engine import search_sim as j_search_sim
from repro.core.graph import build_vamana
from repro.core.luncsr import LUNCSR, Geometry, pack_index
from repro.core.ref_search import SearchParams as JSP
from repro_torch.core.engine import (EngineGeom, EngineParams,
                                     pack_for_engine, search_sim)
from repro_torch.core.luncsr import PackedIndex
from repro_torch.core.ref_search import SearchParams

STATS = ("rounds", "n_dist", "items_recv", "pages_unique", "drops_b",
         "props_sent", "total_rounds")


def _int_index(n=256, d=16, nq=8, S=2, page=16, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, d)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, alpha=1.2, seed=seed)
    geo = Geometry(num_shards=S, page_size=page, pages_per_block=2, dim=d)
    idx = LUNCSR.from_adjacency(db, adj, geo, entry=medoid, pref_width=4)
    return pack_index(idx, max_degree=8), queries.reshape(S, nq // S, d)


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
def index():
    packed, qsh = _int_index()
    ref = {}

    def reference(W, spec):
        if (W, spec) not in ref:
            consts, geom, entry = j_pack(packed)
            p = JParams.lossless(JSP(L=8, W=W, k=5), qsh.shape[1],
                                 geom.max_degree, spec_width=spec,
                                 kernel_mode="jnp")
            i, d, st = j_search_sim(consts, jnp.asarray(qsh), *entry, p, geom)
            ref[(W, spec)] = (np.asarray(i), np.asarray(d),
                              {k: np.asarray(st[k]) for k in STATS})
        return ref[(W, spec)]

    port = pack_for_engine(as_port_index(packed), device="cpu")
    return packed, qsh, port, reference


@pytest.mark.parametrize("qb", [0, 3, 8])
@pytest.mark.parametrize("spec", [0, 4])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_search_sim_bit_identical_to_reference(index, mode, W, spec, qb):
    packed, qsh, (consts, geom, entry), reference = index
    params = EngineParams.lossless(SearchParams(L=8, W=W, k=5), qsh.shape[1],
                                   geom.max_degree, spec_width=spec,
                                   kernel_mode=mode, coalesce_qb=qb)
    ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                device="cpu")
    want_i, want_d, want_st = reference(W, spec)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(dists.numpy(), want_d)
    for k in STATS:
        np.testing.assert_array_equal(st[k].numpy(), want_st[k], err_msg=k)
    assert st["host_syncs"] == int(want_st["total_rounds"][0]) + 1


def test_pack_for_engine_matches_reference(index):
    packed, _, (consts, geom, entry), _ = index
    jconsts, jgeom, jentry = j_pack(packed)
    for k, v in consts.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jconsts[k]))
    assert dataclasses.asdict(geom) == dataclasses.asdict(jgeom)
    np.testing.assert_array_equal(entry[0].numpy(), np.asarray(jentry[0]))
    assert float(entry[1]) == float(jentry[1]) and entry[2] == int(jentry[2])


def test_params_and_geom_are_frozen_dataclasses():
    p = EngineParams.lossless(SearchParams(L=8), 4, 8)
    assert hash(p) == hash(EngineParams.lossless(SearchParams(L=8), 4, 8))
    assert (p.capacity_a, p.capacity_b, p.kernel_mode) == (4, 32, "auto")
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.spec_width = 3
    assert EngineGeom.__dataclass_params__.frozen


def test_bounded_capacity_drops_match_reference(index):
    """Capacities below lossless drop and count overflow the same way."""
    packed, qsh, (consts, geom, entry), _ = index
    jconsts, jgeom, jentry = j_pack(packed)
    sp = dict(L=8, W=2, k=5)
    jp = JParams(search=JSP(**sp), capacity_a=2, capacity_b=6,
                 kernel_mode="jnp")
    want = j_search_sim(jconsts, jnp.asarray(qsh), *jentry, jp, jgeom)
    for mode in ("ref", "torch"):
        p = EngineParams(search=SearchParams(**sp), capacity_a=2,
                         capacity_b=6, kernel_mode=mode)
        got = search_sim(consts, qsh, *entry, p, geom, device="cpu")
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
        for k in STATS:
            np.testing.assert_array_equal(got[2][k].numpy(),
                                          np.asarray(want[2][k]), err_msg=k)
        assert int(got[2]["drops_b"].sum()) > 0


def test_search_sim_without_device_cpu_raises_when_no_card(index):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    _, qsh, (consts, geom, entry), _ = index
    params = EngineParams.lossless(SearchParams(L=8), qsh.shape[1], 8,
                                   kernel_mode="ref")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        search_sim(consts, qsh, *entry, params, geom)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pack_for_engine(as_port_index(index[0]))
