"""The port's serving driver vs the reference's: the retrieval index and
the retrieved soft-prompt ids, greedy generation with carried weights
and the same soft prompt or audio frames (token ids equal, for an arch
of every family), and the CLI end to end on the CPU."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.engine import EngineParams as JParams
from repro.core.engine import pack_for_engine as j_pack
from repro.core.engine import search_sim as j_search_sim
from repro.core.graph import build_vamana as j_vamana
from repro.core.luncsr import LUNCSR as JLUNCSR
from repro.core.luncsr import Geometry as JGeometry
from repro.core.luncsr import pack_index as j_pack_index
from repro.core.ref_search import SearchParams as JSP
from repro.data.vectors import VectorDataset as JDataset
from repro.launch.serve import greedy_generate as j_greedy
from repro.models import ModelOpts as JOpts
from repro.models import init_params as j_init_params
from repro_torch.configs import get_config, reduced
from repro_torch.core.luncsr import PackedIndex
from repro_torch.launch.serve import (greedy_generate, main,
                                      retrieval_index, serve_inputs,
                                      soft_prompt_from_retrieval)
from repro_torch.models import ModelOpts, params_from_jax


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


D, B, K = 32, 4, 4
PACKED_ARRAYS = ("db", "vnorm", "adj", "adj_owner", "pref", "pref_owner",
                 "blk_perm")


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
    """The reference's retrieval index, built as its
    ``soft_prompt_from_retrieval`` builds it (once for the module)."""
    db = JDataset("serve-db", n=2048, dim=D, clusters=16, seed=0).materialize()
    adj, medoid = j_vamana(db, r=16, seed=0)
    geom = JGeometry(num_shards=1, page_size=64, pages_per_block=4, dim=D)
    packed = j_pack_index(JLUNCSR.from_adjacency(db, adj, geom, entry=medoid),
                          max_degree=16)
    return db, packed


def _reference_retrieval(db, packed, queries, mode):
    """The reference's ``soft_prompt_from_retrieval`` after its build."""
    consts, egeom, entry = j_pack(packed)
    params = JParams.lossless(JSP(L=16, W=1, k=K), queries.shape[0], 16,
                              kernel_mode=mode, coalesce_qb=8)
    ids, dists, _ = j_search_sim(consts, jnp.asarray(queries)[None], *entry,
                                 params, egeom)
    ids = np.asarray(ids[0])
    return db[np.clip(ids, 0, db.shape[0] - 1)], ids, np.asarray(dists[0])


def test_retrieval_index_matches_reference(index):
    db, packed = index
    pdb, ppacked = retrieval_index(D, seed=0)
    np.testing.assert_array_equal(pdb, db)
    for name in PACKED_ARRAYS:
        np.testing.assert_array_equal(getattr(ppacked, name),
                                      np.asarray(getattr(packed, name)),
                                      err_msg=name)
    assert (ppacked.entry, ppacked.n) == (packed.entry, packed.n)


@pytest.mark.parametrize("mode", ["ref", "torch"])
def test_soft_prompt_ids_match_reference(index, mode):
    """ids equal the reference's (jnp mode) except where two candidates'
    real-valued distances tie within f32 rounding: the two packages sum
    the squared distances in different orders."""
    db, packed = index
    queries = np.random.default_rng(3).standard_normal(
        (B, D)).astype(np.float32)
    vecs, ids, dists = soft_prompt_from_retrieval(
        None, queries, k=K, kernel_mode=mode, device="cpu",
        index=(db, _as_port_index(packed)))
    wvecs, wids, wdists = _reference_retrieval(db, packed, queries, "jnp")
    assert vecs.shape == (B, K, D) and ids.shape == (B, K)
    np.testing.assert_allclose(dists, wdists, rtol=1e-5, atol=1e-5)
    differ = ids != wids
    if differ.any():             # only inside a near-tie of distances
        gap = np.abs(dists - wdists)[differ]
        assert np.all(gap <= 1e-5 * np.abs(wdists[differ]) + 1e-5)
    else:
        np.testing.assert_array_equal(vecs, wvecs)


def test_streaming_retrieval_raises(index):
    """Streaming retrieval runs (tests/test_torch_serve_stream.py), on
    the card by default: without one it raises unless the caller asks
    for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    port_index = (index[0], _as_port_index(index[1]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        soft_prompt_from_retrieval(None, np.zeros((2, D), np.float32),
                                   streaming=True, index=port_index)
    vecs, ids, _ = soft_prompt_from_retrieval(
        None, np.ones((2, D), np.float32), streaming=True, device="cpu",
        index=port_index)
    assert vecs.shape == (2, K, D) and (ids >= 0).all()


def test_greedy_generate_matches_reference(index):
    """Reduced gemma3-1b (6 layers: windowed and global), the reference's
    weights carried across, the same retrieved soft prompt over the
    first k positions: the greedy tokens are equal."""
    arch, sp, gen = "gemma3-1b", 24, 6
    jcfg = dataclasses.replace(j_reduced(j_get_config(arch)), num_layers=6)
    cfg = dataclasses.replace(reduced(get_config(arch)), num_layers=6)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (B, sp)).astype(np.int32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    vecs, _, _ = soft_prompt_from_retrieval(
        cfg, queries, k=K, device="cpu", index=(index[0],
                                                _as_port_index(index[1])))
    proj = (0.02 * rng.standard_normal((D, cfg.d_model))).astype(np.float32)
    fe = (vecs @ proj).astype(np.float32)
    want = j_greedy(jparams, jcfg, jnp.asarray(toks), gen=gen,
                    opts=JOpts(remat="none"), frontend_embeds=jnp.asarray(fe))
    stats = {}
    got = greedy_generate(params, cfg, torch.from_numpy(toks).long(),
                          gen=gen, opts=ModelOpts(),
                          frontend_embeds=torch.from_numpy(fe), stats=stats)
    assert got.dtype == torch.int32 and got.shape == (B, gen)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats["logits_finite"] and stats["prefill_s"] > 0


def test_cli_runs_on_cpu(capsys):
    assert main(["--arch", "gemma3-1b", "--reduced", "--rag", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "16", "--gen",
                 "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("retrieved neighbor ids:")
    assert lines[1].startswith("generated (2, 4) tokens")
    res = json.loads(lines[-1])
    assert res["device"] == "cpu" and res["rag"] is True
    for key in ("tok_s", "prefill_ms", "decode_ms_per_token"):
        assert np.isfinite(res[key]) and res[key] > 0
    # on the CPU every wrapper takes its plain version: nothing launches
    assert set(res["launches"]["generate"]) == {
        "paged_distance", "paged_distance_bf16q", "paged_distance_bf16db",
        "paged_distance_bf16q_bf16db", "bitonic_sort", "bitonic_merge",
        "bitonic_merge_unsorted", "flash_attention", "flash_attention_bwd"}
    assert not any(res["launches"]["retrieval"].values())


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mamba2-780m",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_greedy_generate_new_families_match_reference(arch):
    """Reduced moe, ssm, hybrid and encdec archs, the reference's weights
    carried across: greedy tokens equal the reference's greedy_generate
    (seamless with audio frames of the prompt's length, the encoder
    cache sized to them as the reference's main does)."""
    sp, gen = 24, 6
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, jparams),
                             device="cpu")
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, sp)).astype(np.int32)
    fe, enc_len = None, 0
    if cfg.frontend == "audio":
        fe = (0.05 * rng.standard_normal((B, sp, cfg.d_model))
              ).astype(np.float32)
        enc_len = sp
    want = j_greedy(jparams, jcfg, jnp.asarray(toks), gen=gen,
                    opts=JOpts(remat="none"), enc_len=enc_len,
                    frontend_embeds=None if fe is None else jnp.asarray(fe))
    got = greedy_generate(params, cfg, torch.from_numpy(toks).long(),
                          gen=gen, opts=ModelOpts(), enc_len=enc_len,
                          frontend_embeds=None if fe is None
                          else torch.from_numpy(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch,rag", [("mixtral-8x7b", True),
                                      ("dbrx-132b", False),
                                      ("mamba2-780m", True),
                                      ("zamba2-1.2b", True),
                                      ("seamless-m4t-medium", True)])
def test_cli_serves_every_family_on_cpu(capsys, arch, rag):
    """``--reduced --device cpu`` for the moe, ssm, hybrid and encdec
    archs. --rag retrieves soft prompts for the decoder-only families;
    seamless takes the audio stub's frames instead, as the reference's
    ``elif`` does."""
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "16", "--gen", "4"] + ["--rag"] * rag
    assert main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    retrieved = rag and arch != "seamless-m4t-medium"
    assert lines[0].startswith("retrieved neighbor ids:") == retrieved
    res = json.loads(lines[-1])
    assert res["arch"] == arch + "-reduced" and res["device"] == "cpu"
    for key in ("tok_s", "prefill_ms", "decode_ms_per_token"):
        assert np.isfinite(res[key]) and res[key] > 0
    assert not any(res["launches"]["generate"].values())


def test_cli_rejects_stream_retrieval_and_unported_families(capsys):
    """--stream-retrieval is served since the streaming scheduler was
    ported; without a card the CLI refuses it unless --device cpu is
    given. Every family is ported now: a config of a family the port
    does not know raises ValueError."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--arch", "gemma3-1b", "--reduced", "--rag",
                  "--stream-retrieval"])
    cfg = dataclasses.replace(reduced(get_config("mamba2-780m")),
                              family="convnet")
    with pytest.raises(ValueError, match="unknown model family"):
        serve_inputs(cfg, batch=1, prompt_len=8, rag=False, rag_dim=8,
                     seed=0, device="cpu")
