"""The port's host build and CLI vs the reference package's: identical
arrays from one seed, recall on real-valued data, and the same JSON from
the default (non-stream) ANNS driver; the training CLI. The ``--stream``
JSON cases are tests/test_torch_launch_{stream,routed,live}.py's."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from repro_torch.core.engine import SEARCH_CHUNK, pack_for_engine
from repro_torch.core.graph import brute_force_topk, build_vamana, recall_at_k
from repro_torch.core.luncsr import pack_index
from repro_torch.data.vectors import PAPER_DATASETS, VectorDataset
from repro_torch.launch.search import build_index, main, run_search

PACKED_ARRAYS = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
                 "blk_perm")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores; at a fixed thread count torch's CPU results are
    deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    port = run_search(pack_for_engine(packed, device="cpu"), db, queries,
                      shards=4, L=16, W=1, k=10,
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
    # one read per chunk of SEARCH_CHUNK predicated rounds
    assert port["host_syncs"] == -(-port["rounds"] // SEARCH_CHUNK)


# the serving report's wall clocks, and the backend's name
STREAM_CLOCKS = {"kernel_mode", "wall_latency_ms", "sustained_qps", "wall_s",
                 "compile_s"}


def check_stream_json(tmp_path, capsys, flags):
    """``--stream`` serves the queries through the streaming scheduler:
    the JSON equals the reference's ``--stream --kernel-mode jnp`` JSON
    but the clocks; the port adds device, host_syncs (one read per
    chunk: the reference's host blocks) and warmup_rounds. The cases
    are test_cli_stream_json_matches_reference in
    tests/test_torch_launch_{stream,routed,live}.py (one file each, so
    that the suite's workers share them)."""
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "32",
            "--stream"] + flags
    assert main(argv + ["--device", "cpu",
                        "--out", str(tmp_path / "port.json")]) == 0
    j_main(argv + ["--kernel-mode", "jnp",
                   "--out", str(tmp_path / "ref.json")])
    capsys.readouterr()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert set(port) == set(ref) | {"device", "host_syncs",
                                    "warmup_rounds"}
    for key in set(ref) - STREAM_CLOCKS:
        assert port[key] == ref[key], key
    assert port["mode"] == "stream" and port["device"] == "cpu"
    assert port["host_syncs"] == port["host_dispatches"] > 0


def test_cli_topr_needs_stream(capsys):
    """Routing is a serving-path feature, as in the reference CLI."""
    with pytest.raises(SystemExit, match="--stream"):
        main(["--device", "cpu", "--dataset", "tiny", "--n", "512",
              "--topr", "2"])
    with pytest.raises(SystemExit, match="--stream"):
        j_main(["--dataset", "tiny", "--n", "512", "--topr", "2"])
    capsys.readouterr()


def test_cli_stream_refuses_routed_tiered_store(capsys):
    """``--stream --topr`` with ``--device-pages`` exits, as the
    reference CLI does: the tiered store is flat-path only."""
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "8", "--stream",
            "--topr", "2", "--device-pages", "4"]
    with pytest.raises(SystemExit, match="--device-pages needs the flat"):
        main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="--device-pages needs the flat"):
        j_main(argv + ["--kernel-mode", "jnp"])
    capsys.readouterr()


@pytest.mark.parametrize("flag,item", [(["--delta-cap", "16"], 12)])
def test_cli_stream_refuses_unported_flags(capsys, flag, item):
    """The live index (ROADMAP.md queue A item ``item``, once refused
    here) is a serving-path feature: without ``--stream``, and with
    routed legs on shard-local subgraphs, both CLIs exit."""
    argv = ["--dataset", "tiny", "--n", "512"] + flag
    for extra, match in (([], "requires --stream"),
                         (["--stream", "--topr", "2"], "--topr >= --shards")):
        with pytest.raises(SystemExit, match=match):
            main(argv + extra + ["--device", "cpu"])
        with pytest.raises(SystemExit, match=match):
            j_main(argv + extra + ["--kernel-mode", "jnp"])
    capsys.readouterr()


TRAIN_ARGV = ["--device", "cpu", "--reduced", "--arch", "gemma3-1b",
              "--steps", "3"]


def test_train_cli_runs_on_cpu(tmp_path):
    """``python -m repro_torch.launch.train --device cpu --reduced --arch
    gemma3-1b --steps 3``: the reference's log lines, finite losses."""
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGV,
         "--log-every", "1", "--metrics-out", str(tmp_path / "m.json")],
        cwd=repo, capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(repo / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path), "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert [x.split()[:2] for x in lines[:3]] == \
        [["step", str(s)] for s in range(3)]
    assert lines[-1].startswith("done: 3 steps in ")
    hist = json.loads((tmp_path / "m.json").read_text())
    assert [h["step"] for h in hist] == [0, 1, 2]
    assert all(np.isfinite(h["loss"]) and h["skipped"] == 0 for h in hist)


def test_train_cli_checkpoints_and_resumes(tmp_path, capsys):
    """With ``--ckpt-dir`` the supervised loop saves (every
    ``--ckpt-every`` steps and at the end, in the reference's layout); a
    second run with more steps resumes from the latest checkpoint."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch.train import main as train_main
    d = str(tmp_path / "ckpt")
    argv = TRAIN_ARGV + ["--ckpt-dir", d, "--ckpt-every", "2",
                         "--log-every", "1"]
    assert train_main(argv) == 0
    assert ckpt.all_steps(d) == [2, 3]
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == "done at step 3; restarts=0"
    with np.load(f"{d}/step_00000003/shard-0.npz") as z:
        assert z["opt::step"] == 3
        assert z["params::blocks::attn::wq"].shape[0] == 4   # stacked
    argv5 = [a if a != "3" else "5" for a in argv]
    assert train_main(argv5) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [x.split()[1] for x in out[:-1]] == ["3", "4"]   # resumed at 3
    assert ckpt.all_steps(d) == [3, 4, 5]
