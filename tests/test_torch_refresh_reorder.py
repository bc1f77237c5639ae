"""The port's host-side block refresh, reorder baselines and traffic
model against the reference package's: ``refresh_blocks`` equal to its
per-pair regression twin and to the reference's, array for array, over
seeds and fractions; ``random_bfs`` and ``identity_order`` equal to the
reference's orders; ``gather_baseline_bytes`` equal dicts."""
import numpy as np
import pytest

from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.core.refresh import physical_page_of as j_physical_page_of
from repro.core.refresh import refresh_blocks as j_refresh_blocks
from repro.core.reorder import identity_order as j_identity_order
from repro.core.reorder import random_bfs as j_random_bfs
from repro.core.traversal import gather_baseline_bytes as j_gbb
from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.refresh import (_refresh_blocks_loop,
                                      physical_page_of, refresh_blocks)
from repro_torch.core.reorder import identity_order, random_bfs
from repro_torch.core.traversal import gather_baseline_bytes

ARRAYS = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
          "blk_perm")


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(0)
    db = rng.standard_normal((600, 16)).astype(np.float32)
    adj, medoid = j_vamana(db, r=8, seed=0)
    return db, adj, medoid


def _packed(graph, stripe, ppb, port: bool):
    db, adj, medoid = graph
    kw = dict(num_shards=4, page_size=16, pages_per_block=ppb, dim=16,
              stripe=stripe)
    if port:
        return pack_index(LUNCSR.from_adjacency(
            db, adj, Geometry(**kw), entry=medoid, pref_width=3), 8)
    return j_pack_index(JLUNCSR.from_adjacency(
        db, adj, JGeometry(**kw), entry=medoid, pref_width=3), 8)


@pytest.mark.parametrize("stripe,ppb", [("striped", 2), ("sequential", 1),
                                        ("striped", 3)])
@pytest.mark.parametrize("frac", [0.1, 0.25, 0.5, 1.0])
@pytest.mark.parametrize("seed", [0, 42])
def test_refresh_blocks_equals_loop_and_reference(graph, stripe, ppb, frac,
                                                  seed):
    packed = _packed(graph, stripe, ppb, port=True)
    jpacked = _packed(graph, stripe, ppb, port=False)
    got = refresh_blocks(packed, np.random.default_rng(seed), frac)
    loop = _refresh_blocks_loop(packed, np.random.default_rng(seed), frac)
    want = j_refresh_blocks(jpacked, np.random.default_rng(seed), frac)
    for name in ARRAYS:
        a = getattr(got, name)
        np.testing.assert_array_equal(a, getattr(loop, name), err_msg=name)
        np.testing.assert_array_equal(a, getattr(want, name), err_msg=name)
        assert a.dtype == getattr(want, name).dtype, name
    # the refreshed store still resolves every id to its own vector
    ids = np.arange(packed.n)
    s, p, sl = physical_page_of(got, ids)
    np.testing.assert_array_equal(got.db[s, p, sl][:, :16], graph[0])
    for a, b in zip((s, p, sl), j_physical_page_of(want, ids)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_bfs_equals_reference(graph, seed):
    _, adj, _ = graph
    order = random_bfs(adj, seed=seed)
    np.testing.assert_array_equal(order, j_random_bfs(adj, seed=seed))
    assert sorted(order.tolist()) == list(range(adj.shape[0]))


def test_identity_order_equals_reference():
    np.testing.assert_array_equal(identity_order(37), j_identity_order(37))
    assert identity_order(5).dtype == np.int64


@pytest.mark.parametrize("d,dtype_bytes,R", [(128, 4, 32), (96, 2, 16),
                                             (784, 4, 64)])
def test_gather_baseline_bytes_equals_reference(d, dtype_bytes, R):
    got = gather_baseline_bytes(SearchParams(), d, dtype_bytes, R)
    assert got == j_gbb(JSP(), d, dtype_bytes, R)
    assert got["filter_ratio"] > 1.0
