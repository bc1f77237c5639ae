"""The port's host build and CLI vs the reference package's: identical
arrays from one seed, recall on real-valued data, and the same JSON from
the default (non-stream) ANNS driver."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.engine import search_sim as j_search_sim
from repro.core.graph import brute_force_topk as j_bf
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.data.vectors import PAPER_DATASETS as J_DATASETS
from repro.data.vectors import VectorDataset as JDataset
from repro.launch.search import build_index as j_build_index
from repro.launch.search import main as j_main
from repro_torch.core.graph import brute_force_topk, build_vamana, recall_at_k
from repro_torch.core.luncsr import pack_index
from repro_torch.data.vectors import PAPER_DATASETS, VectorDataset
from repro_torch.launch.search import build_index, main, run_search

PACKED_ARRAYS = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
                 "blk_perm")


@pytest.fixture(scope="module")
def tiny():
    ds = VectorDataset("tiny", n=512, dim=64, clusters=16)
    db0 = ds.materialize()
    kw = dict(shards=4, page_size=32, r=8, pref_width=2, seed=0)
    return ds, db0, build_index(db0, **kw), j_build_index(db0, **kw)


def test_datasets_are_the_reference_configs():
    assert {k: dataclasses.asdict(v) for k, v in PAPER_DATASETS.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_DATASETS.items()}
    ds, jds = (cls("t", n=300, dim=24, clusters=5, seed=3)
               for cls in (VectorDataset, JDataset))
    np.testing.assert_array_equal(ds.materialize(), jds.materialize())
    np.testing.assert_array_equal(ds.queries(17, seed=2),
                                  jds.queries(17, seed=2))


def test_host_build_bit_identical_to_reference(tiny):
    _, _, (db, packed), (jdb, jpacked) = tiny
    np.testing.assert_array_equal(db, jdb)
    for name in PACKED_ARRAYS:
        a, b = getattr(packed, name), getattr(jpacked, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (packed.entry, packed.n, packed.max_degree) == \
        (jpacked.entry, jpacked.n, jpacked.max_degree)
    assert dataclasses.asdict(packed.geometry) == \
        dataclasses.asdict(jpacked.geometry)


def test_vamana_and_ground_truth_identical_on_integer_data():
    rng = np.random.default_rng(4)
    db = rng.integers(-8, 9, size=(200, 12)).astype(np.float32)
    q = rng.integers(-8, 9, size=(9, 12)).astype(np.float32)
    adj, med = build_vamana(db, r=6, seed=4)
    jadj, jmed = j_vamana(db, r=6, seed=4)
    np.testing.assert_array_equal(adj, jadj)
    assert med == jmed
    for a, b in zip(brute_force_topk(db, q, 5), j_bf(db, q, 5)):
        np.testing.assert_array_equal(a, b)


def test_real_valued_recall_agrees(tiny):
    """Real-valued vectors: torch and XLA sum in different orders, so
    ids may differ in a near-tie; recall@k must agree within 0.01."""
    ds, _, (db, packed), _ = tiny
    queries = ds.queries(32, seed=1)
    port = run_search(packed, db, queries, shards=4, L=16, W=1, k=10,
                      spec=0, kernel_mode="ref", coalesce_qb=8, device="cpu")
    consts, geom, entry = j_pack(packed)
    p = JParams.lossless(JSP(L=16, W=1, k=10), 8, 8, kernel_mode="jnp")
    ids, _, _ = j_search_sim(consts, jnp.asarray(queries.reshape(4, 8, -1)),
                             *entry, p, geom)
    true_ids, _ = brute_force_topk(db, queries, 10)
    jrec = recall_at_k(np.asarray(ids).reshape(32, -1), true_ids)
    assert abs(port["recall@k"] - jrec) <= 0.01
    assert port["recall@k"] > 0.8


def test_pack_index_identical_with_prefetch_lists(tiny):
    """Speculative prefetch lists pack the same way in both packages."""
    from repro.core.luncsr import LUNCSR as JLUNCSR
    from repro.core.luncsr import Geometry as JGeometry
    from repro_torch.core.luncsr import LUNCSR, Geometry
    _, db0, _, _ = tiny
    adj, med = j_vamana(db0[:128], r=6, seed=1)
    kw = dict(num_shards=2, page_size=16, pages_per_block=2, dim=64,
              stripe="sequential")
    a = pack_index(LUNCSR.from_adjacency(db0[:128], adj, Geometry(**kw),
                                         entry=med, pref_width=3), 6)
    b = j_pack_index(JLUNCSR.from_adjacency(db0[:128], adj, JGeometry(**kw),
                                            entry=med, pref_width=3), 6)
    for name in PACKED_ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_cli_json_matches_reference(tmp_path, capsys):
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "32"]
    main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.json")])
    j_main(argv + ["--kernel-mode", "jnp", "--out", str(tmp_path / "ref.json")])
    capsys.readouterr()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    for key in ("dataset", "n", "queries", "coalesce_qb", "recall@k",
                "rounds", "mean_dists_per_query", "pages_unique",
                "items_recv"):
        assert port[key] == ref[key], key
    assert port["kernel_mode"] == "auto" and port["device"] == "cpu"
    assert port["host_syncs"] == port["rounds"] + 1
