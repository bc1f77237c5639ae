"""The port's streaming serving CLI and streaming RAG retrieval vs the
reference's: the same JSON counts from ``serve_stream`` on the same
flags (the tiered page store's and the live index's among them), the
live index's refusals the reference's, streaming soft-prompt
retrieval returning the reference's ids and greedy tokens with carried
weights, and the entry points refusing to run without a card unless the
caller asks for the CPU. The routed, ring and tiered JSON cases are
tests/test_torch_serve_stream_routed.py's, the live index's
tests/test_torch_serve_stream_live.py's."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.data.vectors import VectorDataset as JDataset
from repro.launch.serve import greedy_generate as j_greedy
from repro.launch.serve_stream import StreamingRetriever as JRetriever
from repro.launch.serve_stream import main as j_main
from repro.models import ModelOpts as JOpts
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.luncsr import PackedIndex
from repro_torch.launch import serve
from repro_torch.launch.serve_stream import StreamingRetriever, main
from repro_torch.models import ModelOpts, params_from_jax

D, B, K = 32, 4, 4
# the serving report's counts: everything but the clocks and the names
# of the backend and device
CLOCKS = {"kernel_mode", "wall_latency_ms", "sustained_qps", "wall_s",
          "compile_s"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores; at a fixed thread count torch's CPU results are
    deterministic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
def index():
    """The reference's RAG retrieval index, as its serve driver builds
    it."""
    db = JDataset("serve-db", n=2048, dim=D, clusters=16, seed=0).materialize()
    adj, medoid = j_vamana(db, r=16, seed=0)
    geom = JGeometry(num_shards=1, page_size=64, pages_per_block=4, dim=D)
    packed = j_pack_index(JLUNCSR.from_adjacency(db, adj, geom, entry=medoid),
                          max_degree=16)
    return db, packed


@pytest.mark.parametrize("flags", [
    [], ["--spec", "4", "--spec-dynamic", "--arrival-rate", "0.5"],
    ["--no-refill", "--round-chunk", "3", "--deadline-rounds", "6"],
    ["--injit-admit", "off", "--slots", "3", "--spec", "2"],
    # the fault flags: delay plans, a kill under a deadline, page
    # corruption guarded and unguarded (the hash salted by --seed)
    ["--delay-shard", "0:2:5", "--delay-shard", "2:4:3"],
    ["--kill-shard", "1:4", "--deadline-rounds", "12", "--seed", "1"],
    ["--corrupt-pages", "0.08", "--corrupt-mode", "neg", "--nan-guard"],
    ["--corrupt-pages", "0.08", "--corrupt-mode", "neg", "--spec", "2"]])
def test_cli_json_matches_reference(tmp_path, capsys, flags):
    check_cli_json(tmp_path, capsys, flags)


def check_cli_json(tmp_path, capsys, flags):
    """The JSON of ``serve_stream`` equals the reference's on the same
    flags but the clocks and the names of the backend and device; the
    routed, ring and tiered cases are
    tests/test_torch_serve_stream_routed.py's, the live index's
    tests/test_torch_serve_stream_live.py's."""
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "32"] + flags
    assert main(argv + ["--device", "cpu",
                        "--out", str(tmp_path / "port.json")]) == 0
    j_main(argv + ["--kernel-mode", "jnp",
                   "--out", str(tmp_path / "ref.json")])
    capsys.readouterr()
    port = json.loads((tmp_path / "port.json").read_text())
    ref = json.loads((tmp_path / "ref.json").read_text())
    assert set(port) == set(ref) | {"device", "host_syncs",
                                    "warmup_rounds"}
    for key in set(ref) - CLOCKS:
        assert port[key] == ref[key], key
    assert port["kernel_mode"] == "auto" and port["device"] == "cpu"
    # one read per chunk, at its boundary: the reference's host blocks
    assert port["host_syncs"] == port["host_dispatches"] > 0


def test_cli_refuses_routed_tiered_store(capsys):
    """The tiered store is flat-path only: ``--topr`` with
    ``--device-pages`` exits, as the reference CLI does."""
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "8", "--topr",
            "2", "--device-pages", "4"]
    with pytest.raises(SystemExit, match="--device-pages needs the flat"):
        main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="--device-pages needs the flat"):
        j_main(argv + ["--kernel-mode", "jnp"])
    capsys.readouterr()


@pytest.mark.parametrize("flag,item", [
    (["--delta-cap", "16", "--topr", "2"], 12),
    (["--delta-cap", "16", "--topr", "1", "--insert-rate", "0.5"], 12)])
def test_cli_refuses_unported_flags(capsys, flag, item):
    """The live index's flags (ROADMAP.md queue A item ``item``, once
    refused here) run; the one configuration the reference CLI refuses,
    routed legs on shard-local subgraphs (``--topr`` below ``--shards``),
    exits in both CLIs."""
    argv = ["--dataset", "tiny", "--n", "512", "--queries", "8"] + flag
    with pytest.raises(SystemExit, match="--topr >= --shards"):
        main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="--topr >= --shards"):
        j_main(argv + ["--kernel-mode", "jnp"])
    capsys.readouterr()


def test_unported_flags_are_the_references(capsys):
    """The live index's four flags, ported, are the reference CLI's, with
    its defaults."""
    with pytest.raises(SystemExit):
        j_main(["--help"])
    ref_help = capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--help"])
    port_help = capsys.readouterr().out
    for flag in ("--insert-rate", "--delete-rate", "--delta-cap",
                 "--refresh-every"):
        for text in (ref_help, port_help):
            assert f"{flag} " in text or f"{flag}\n" in text, flag


def test_streaming_retriever_matches_reference(index):
    """Streaming retrieval through the slot pool returns the reference
    retriever's ids (distances within f32 rounding: the packages sum in
    different orders), and the same ids as the port's frozen batch."""
    db, packed = index
    queries = np.random.default_rng(3).standard_normal((9, D)).astype(
        np.float32)
    kw = dict(L=16, W=1, k=K, num_slots=2)
    vecs, ids, dists, st = StreamingRetriever(
        db, _as_port_index(packed), **kw, device="cpu").retrieve(queries)
    wvecs, wids, wdists, wst = JRetriever(db, packed, **kw,
                                          kernel_mode="jnp").retrieve(
        queries)
    np.testing.assert_array_equal(ids, wids)
    np.testing.assert_array_equal(vecs, wvecs)
    np.testing.assert_allclose(dists, wdists, rtol=1e-5, atol=1e-5)
    assert st.total_rounds == wst.total_rounds
    _, fids, _ = serve.soft_prompt_from_retrieval(
        None, queries, k=K, device="cpu", index=(db, _as_port_index(packed)))
    np.testing.assert_array_equal(ids, fids)


def test_stream_retrieval_greedy_tokens_match_reference(index):
    """Reduced gemma3-1b with the reference's weights carried across,
    the soft prompt retrieved by streaming in each package: the same
    neighbour ids and the same greedy tokens."""
    arch, sp, gen = "gemma3-1b", 24, 6
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), num_layers=6)
    cfg = dataclasses.replace(reduced(get_config(arch)), num_layers=6)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, sp)).astype(np.int32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    db, packed = index
    vecs, ids, _ = serve.soft_prompt_from_retrieval(
        cfg, queries, k=K, streaming=True, device="cpu",
        index=(db, _as_port_index(packed)))
    # the reference's soft_prompt_from_retrieval(streaming=True), after
    # its index build
    wvecs, wids, _, _ = JRetriever(db, packed, L=16, W=1, k=K,
                                   num_slots=max(1, B // 2),
                                   kernel_mode="jnp").retrieve(queries)
    np.testing.assert_array_equal(ids, wids)
    proj = (0.02 * rng.standard_normal((D, cfg.d_model))).astype(np.float32)
    want = j_greedy(jparams, jcfg, jnp.asarray(toks), gen=gen,
                    opts=JOpts(remat="none"),
                    frontend_embeds=jnp.asarray(wvecs @ proj))
    got = serve.greedy_generate(
        params, cfg, torch.from_numpy(toks).long(), gen=gen,
        opts=ModelOpts(), frontend_embeds=torch.from_numpy(vecs @ proj))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_serve_cli_stream_retrieval_on_cpu(capsys):
    """``serve --rag --stream-retrieval --device cpu`` retrieves through
    the streaming scheduler and generates; on the CPU nothing launches."""
    assert serve.main(["--arch", "gemma3-1b", "--reduced", "--rag",
                       "--stream-retrieval", "--device", "cpu", "--batch",
                       "2", "--prompt-len", "16", "--gen", "3"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ids = json.loads(lines[0].split(":", 1)[1])
    assert np.shape(ids) == (2, 4) and 0 <= np.min(ids) <= np.max(ids) < 2048
    res = json.loads(lines[-1])
    assert res["stream_retrieval"] is True and res["device"] == "cpu"
    assert np.isfinite(res["tok_s"]) and res["tok_s"] > 0
    assert not any(res["launches"]["retrieval"].values())


def test_entry_points_raise_without_a_card(index, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    db, packed = index
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRetriever(db, _as_port_index(packed))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--dataset", "tiny", "--n", "512"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.soft_prompt_from_retrieval(None, np.zeros((2, D), np.float32),
                                         streaming=True, index=(
                                             db, _as_port_index(packed)))
