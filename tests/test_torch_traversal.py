"""Port single-shard ``traversal.search`` vs the reference's (jnp mode)
and vs the port's numpy lockstep oracle: ids, dists, rounds, n_dist and
page_accesses bit for bit on integer-valued vectors."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.graph import build_vamana
from repro.core.ref_search import SearchParams as JSP
from repro.core.backend import KernelBackend as JBackend
from repro.core.traversal import search as j_search
from repro.core.traversal import sort_by_dist_id as j_sort_by_dist_id
from repro_torch.core.ref_search import SearchParams, lockstep_search_batch
from repro_torch.core.backend import KernelBackend
from repro_torch.core.traversal import (count_unique_pages, dedup_in_round,
                                        search, select_expand,
                                        sort_by_dist_id)

STATS = ("rounds", "n_dist", "page_accesses")


@pytest.fixture(scope="module")
def ds():
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(256, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(6, 16)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, alpha=1.2, seed=0)
    vnorm = (db.astype(np.float64) ** 2).sum(-1).astype(np.float32)
    return db, queries, adj, medoid, vnorm, {}


def _reference(ds, W):
    db, queries, adj, medoid, vnorm, cache = ds
    if W not in cache:
        i, d, st = j_search(db, adj, vnorm, queries, medoid,
                            JSP(L=8, W=W, k=5), page_size=32,
                            kernel_mode="jnp")
        cache[W] = (np.asarray(i), np.asarray(d),
                    {k: np.asarray(st[k]) for k in STATS + ("total_rounds",)})
    return cache[W]


@pytest.mark.parametrize("qb", [0, 3, 8])
@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_search_bit_identical_to_reference(ds, mode, W, qb):
    db, queries, adj, medoid, vnorm, _ = ds
    ids, dists, st = search(db, adj, vnorm, queries, medoid,
                            SearchParams(L=8, W=W, k=5), page_size=32,
                            kernel_mode=mode, coalesce_qb=qb, device="cpu")
    want_i, want_d, want_st = _reference(ds, W)
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(dists.numpy(), want_d)
    for k in STATS:
        np.testing.assert_array_equal(st[k].numpy(), want_st[k], err_msg=k)
    assert st["total_rounds"] == int(want_st["total_rounds"])


@pytest.mark.parametrize("W", [1, 2, 4])
def test_search_matches_numpy_oracle(ds, W):
    db, queries, adj, medoid, vnorm, _ = ds
    sp = SearchParams(L=8, W=W, k=5)
    ids, dists, st = search(db, adj, vnorm, queries, medoid, sp,
                            kernel_mode="ref", device="cpu")
    oi, od, orounds = lockstep_search_batch(db, adj, queries, medoid, sp)
    np.testing.assert_array_equal(ids.numpy(), oi)
    np.testing.assert_array_equal(dists.numpy(), od)
    np.testing.assert_array_equal(st["rounds"].numpy(), orounds)


def test_select_expand_and_dedup_batched():
    cd = torch.tensor([[[1.0, 2.0, 3.0, 3e38]], [[0.5, 0.7, 3e38, 3e38]]])
    ci = torch.tensor([[[4, 9, 2, 2**31 - 1]], [[7, 1, 2**31 - 1,
                                                   2**31 - 1]]],
                      dtype=torch.int32)
    ce = torch.tensor([[[True, False, False, False]],
                       [[False, False, False, False]]])
    ids, valid, ce2 = select_expand(cd, ci, ce, W=2)
    assert ids.tolist() == [[[9, 2]], [[7, 1]]]
    assert valid.all() and ce2[0, 0, :3].all() and ce2[1, 0, :2].all()
    assert not ce2[1, 0, 2:].any() and not ce2[0, 0, 3]
    props = torch.tensor([[3, 5, 3, -1, 5, 6]])
    keep = dedup_in_round(props, props != -1)
    assert keep.tolist() == [[True, True, False, False, False, True]]
    pages = count_unique_pages(props, keep, page_size=4)
    assert pages.tolist() == [2]                 # 3, 5, 6 -> pages 0, 1, 1


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_sort_by_dist_id_matches_reference(mode):
    """Batched (dist, id) sort with a payload lane, leading axes kept."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 5, (2, 3, 12)).astype(np.float32)
    i = rng.permutation(72).reshape(2, 3, 12).astype(np.int32)
    e = rng.integers(0, 2, (2, 3, 12)).astype(bool)
    want = j_sort_by_dist_id(jnp.asarray(d), jnp.asarray(i), jnp.asarray(e),
                             backend=JBackend(mode="jnp"))
    got = sort_by_dist_id(*(torch.as_tensor(x) for x in (d, i, e)),
                          backend=KernelBackend(mode=mode))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
