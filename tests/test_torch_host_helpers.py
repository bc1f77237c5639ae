"""The host helpers the port copies from the reference, against it on
the same numpy inputs: ``classic_beam_search`` (``core/ref_search.py``)
on tests/test_traversal.py's integer dataset, ids and distances bit for
bit; ``build_hnsw_lite`` (``core/graph.py``) for one seed, the same
level ids, adjacency and entry; ``human_bytes``, ``tree_bytes`` and
``pad_axis`` (``utils.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import utils as j_utils
from repro.core.graph import build_hnsw_lite as j_build_hnsw_lite
from repro.core.graph import build_vamana as j_build_vamana
from repro.core.ref_search import classic_beam_search as j_classic
from repro_torch import utils
from repro_torch.core.graph import HNSWLite, build_hnsw_lite, build_vamana
from repro_torch.core.ref_search import classic_beam_search


@pytest.fixture(scope="module")
def ds():
    """tests/test_traversal.py's dataset: integer-valued vectors."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(512, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(16, 32)).astype(np.float32)
    adj, medoid = build_vamana(db, r=12, alpha=1.2, seed=0)
    j_adj, j_medoid = j_build_vamana(db, r=12, alpha=1.2, seed=0)
    np.testing.assert_array_equal(adj, j_adj)
    assert medoid == j_medoid
    return db, queries, adj, medoid


@pytest.mark.parametrize("L,k", [(32, 10), (8, 4), (64, 16)])
def test_classic_beam_search_equals_the_references(ds, L, k):
    db, queries, adj, medoid = ds
    for q in queries:
        ids, dists = classic_beam_search(db, adj, q, medoid, L=L, k=k)
        j_ids, j_dists = j_classic(db, adj, q, medoid, L=L, k=k)
        assert ids.dtype == j_ids.dtype and dists.dtype == j_dists.dtype
        np.testing.assert_array_equal(ids, j_ids)
        np.testing.assert_array_equal(dists.view(np.int32),
                                      j_dists.view(np.int32))


@pytest.mark.parametrize("seed", [0, 3])
def test_hnsw_lite_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    vecs = rng.standard_normal((300, 16)).astype(np.float32)
    kw = dict(r=12, r_upper=8, scale=8, max_levels=3, seed=seed)
    got, want = build_hnsw_lite(vecs, **kw), j_build_hnsw_lite(vecs, **kw)
    assert isinstance(got, HNSWLite)
    assert len(got.level_ids) == len(want.level_ids) > 1
    for a, b in zip(got.level_ids, want.level_ids):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got.level_adj, want.level_adj):
        np.testing.assert_array_equal(a, b)
    assert got.entry == want.entry


@pytest.mark.parametrize("n", [0, 1023, 1024, 5 * 2**20 + 7, 3.5 * 2**40,
                               -2048, 2**60])
def test_human_bytes_equals_the_references(n):
    assert utils.human_bytes(n) == j_utils.human_bytes(n)


def test_tree_bytes_equals_the_references():
    arrays = {"a": np.zeros((3, 5), np.float32),
              "b": [np.zeros(7, np.int64), (np.zeros((2, 2), np.float16),)],
              "c": 3.0}
    want = j_utils.tree_bytes(arrays)
    assert utils.tree_bytes(arrays) == want
    tensors = {"a": torch.zeros((3, 5)),
               "b": [torch.zeros(7, dtype=torch.int64),
                     (torch.zeros((2, 2), dtype=torch.float16),)]}
    assert utils.tree_bytes(tensors) == want
    assert j_utils.tree_bytes({"x": jnp.zeros((4, 4))}) == \
        utils.tree_bytes({"x": torch.zeros((4, 4))})


@pytest.mark.parametrize("axis,size,fill", [(0, 5, 0), (1, 6, -1),
                                            (1, 3, 0)])
def test_pad_axis_equals_the_references(axis, size, fill):
    x = np.arange(6, dtype=np.int32).reshape(2, 3)
    got = utils.pad_axis(x, size, axis, fill)
    np.testing.assert_array_equal(got, j_utils.pad_axis(x, size, axis, fill))
    assert got.dtype == x.dtype
    with pytest.raises(AssertionError):
        utils.pad_axis(x, 1, 1)
