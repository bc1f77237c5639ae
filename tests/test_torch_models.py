"""The port's models vs the reference's, with the reference's weights
carried across (``params_from_jax``) and the same numpy inputs: full
logits (and the moe family's lb_loss and drop_frac), prefill logits and
every cache (KV, SSM and conv states, cross K/V and the encoder length),
and several decode steps, on an arch of every family at ``reduced`` size
(gemma3-1b at 6 layers, so its 6th — global — layer is included beside 5
windowed ones; seamless with 16 audio frames in a 20-row encoder cache,
so decode's cross-attention masks the padding). Tolerance 1e-4 (abs and
rel) in f32: torch and XLA sum each product in another order, over a few
layers; logits are O(10). Plus the port's own twin of
tests/test_models_decode.py, the weight round trip and the frontend
stubs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import list_archs as j_list_archs
from repro.configs import reduced as j_reduced
from repro.models import ModelOpts as JOpts
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import logits_fn as j_logits_fn
from repro.models import prefill as j_prefill
from repro.models.frontend import frontend_shape as j_frontend_shape
from repro.models.params import count_params as j_count_params
from repro.models.transformer import model_spec as j_model_spec
from repro_torch.configs import get_config, list_archs, reduced
from repro_torch.models import (ModelOpts, audio_stub, decode_step, encode,
                                frontend_shape, init_cache, init_params,
                                logits_fn, params_from_jax, params_to_numpy,
                                prefill, vision_stub)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["gemma3-1b", "gemma2-27b", "yi-34b", "llama3-405b",
         "llava-next-mistral-7b", "mixtral-8x7b", "dbrx-132b", "mamba2-780m",
         "zamba2-1.2b", "seamless-m4t-medium"]
B, SP, T = 2, 40, 5          # SP > the reduced window (16): masking bites
SE, ENC_LEN = 16, 20         # audio frames; the encoder cache's rows
TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(arch):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    if arch == "gemma3-1b":
        jcfg = dataclasses.replace(jcfg, num_layers=6)
        cfg = dataclasses.replace(cfg, num_layers=6)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    jcfg, cfg = _cfgs(request.param)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(1))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, SP + T)).astype(np.int32)
    fe = None
    if cfg.frontend == "vision":
        fe = (0.1 * rng.standard_normal((B, cfg.frontend_tokens,
                                         cfg.d_model))).astype(np.float32)
    elif cfg.frontend == "audio":
        fe = (0.1 * rng.standard_normal((B, SE, cfg.d_model))
              ).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, tree=tree,
                params=params_from_jax(cfg, tree, device="cpu"), toks=toks,
                fe=fe)


def _fe(c, torch_side):
    if c["fe"] is None:
        return None
    return torch.from_numpy(c["fe"]) if torch_side else jnp.asarray(c["fe"])


def test_configs_are_the_reference_configs():
    assert list_archs() == j_list_archs()
    for arch in list_archs():
        for c, jc in ((get_config(arch), j_get_config(arch)),
                      (reduced(get_config(arch)),
                       j_reduced(j_get_config(arch)))):
            assert dataclasses.asdict(c) == dataclasses.asdict(jc)
            assert c.layer_windows() == jc.layer_windows()
            assert c.vocab_padded() == jc.vocab_padded()
            assert c.param_count() == jc.param_count()
    g3 = get_config("gemma3-1b")
    assert (g3.num_layers, g3.d_model, g3.num_heads, g3.num_kv_heads,
            g3.head_dim, g3.d_ff, g3.vocab_size) == (26, 1152, 4, 1, 256,
                                                     6912, 262144)
    assert [i for i, w in enumerate(g3.layer_windows()) if w == 0] == \
        [5, 11, 17, 23]


def test_params_round_trip(carried):
    back = params_to_numpy(carried["params"])
    flat, _ = jax.tree_util.tree_flatten_with_path(carried["tree"])
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, want in flat:
        got = back
        for p in path:
            got = got[p.key]
        np.testing.assert_array_equal(got, want)
    assert sum(p.numel() for p in carried["params"].parameters()) == \
        j_count_params(j_model_spec(carried["jcfg"]))


def test_logits_match_reference(carried):
    c = carried
    want, jaux = j_logits_fn(c["jparams"], c["jcfg"], jnp.asarray(c["toks"]),
                          opts=JOpts(remat="none"),
                          frontend_embeds=_fe(c, False))
    got, aux = logits_fn(c["params"], c["cfg"],
                         torch.from_numpy(c["toks"]).long(),
                         frontend_embeds=_fe(c, True))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(aux) == sorted(jaux) == (
        ["drop_frac", "lb_loss"] if c["cfg"].family == "moe" else [])
    for name in jaux:      # moe: the same drops, the same balance loss
        assert float(aux[name]) == pytest.approx(float(jaux[name]),
                                                 rel=1e-5, abs=1e-7)


def test_prefill_cache_and_decode_match_reference(carried):
    c = carried
    cfg, jcfg = c["cfg"], c["jcfg"]
    jopts = JOpts(remat="none")
    jcache = j_init_cache(jcfg, B, SP + T, enc_len=ENC_LEN,
                          dtype=jnp.float32)
    jl, jcache = j_prefill(c["jparams"], jcfg, jnp.asarray(c["toks"][:, :SP]),
                           jcache, opts=jopts, frontend_embeds=_fe(c, False))
    cache = init_cache(cfg, B, SP + T, enc_len=ENC_LEN, dtype=torch.float32,
                       device="cpu")
    toks = torch.from_numpy(c["toks"]).long()
    lg, cache = prefill(c["params"], cfg, toks[:, :SP], cache,
                        frontend_embeds=_fe(c, True))
    np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL)
    assert sorted(cache) == sorted(jcache)
    assert cache["pos"] == int(jcache["pos"]) == SP
    if cfg.family == "encdec":
        assert cache["enc_len"] == int(jcache["enc_len"]) == SE
    for name in set(cache) - {"pos", "enc_len"}:
        got, want = cache[name], jcache[name]
        if name in ("ssm", "conv"):          # stacked (L, ...) states
            got, want = list(got), list(want)
            assert len(got) == cfg.num_layers
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                       err_msg=name)
    for t in range(T - 1):
        jl, jcache = j_decode_step(c["jparams"], jcfg, jcache,
                                   jnp.asarray(c["toks"][:, SP + t:SP + t + 1]),
                                   opts=jopts)
        lg, cache = decode_step(c["params"], cfg, cache,
                                toks[:, SP + t:SP + t + 1])
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), **TOL,
                                   err_msg=f"decode step {t}")
    assert cache["pos"] == int(jcache["pos"]) == SP + T - 1


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own twin of tests/test_models_decode.py (5e-3, as
    there): prefill + decode over a cache equals the full forward. The
    moe archs run at capacity factor E, as there: decode buckets one
    token's items, prefill the whole prompt's, so drops would differ."""
    _, cfg = _cfgs(arch)
    opts = ModelOpts(cap_factor=float(max(cfg.num_experts, 1)))
    gen = torch.Generator().manual_seed(2)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, SP + T), generator=gen)
    fe = None
    if cfg.frontend == "vision":
        fe = vision_stub(cfg, B, gen)
    elif cfg.frontend == "audio":
        fe = audio_stub(cfg, B, SE, gen)
    full, _ = logits_fn(params, cfg, toks, opts=opts, frontend_embeds=fe)
    cache = init_cache(cfg, B, SP + T, enc_len=ENC_LEN, dtype=torch.float32,
                       device="cpu")
    lg, cache = prefill(params, cfg, toks[:, :SP], cache, opts=opts,
                        frontend_embeds=fe)
    torch.testing.assert_close(lg, full[:, SP - 1], rtol=5e-3, atol=5e-3)
    for t in range(T - 1):
        lg, cache = decode_step(params, cfg, cache, toks[:, SP + t:SP + t + 1],
                                opts=opts)
        torch.testing.assert_close(lg, full[:, SP + t], rtol=5e-3, atol=5e-3)
    assert cache["pos"] == SP + T - 1


def test_materialize_is_seeded_and_scaled():
    _, cfg = _cfgs("gemma3-1b")
    a = init_params(cfg, torch.Generator().manual_seed(5))
    b = init_params(cfg, torch.Generator().manual_seed(5))
    for x, y in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert not any(p.requires_grad for p in a.parameters())
    blk = a["blocks"][0]
    assert torch.equal(blk["ln1"]["scale"], torch.ones(cfg.d_model))
    w1 = blk["mlp"]["w1"]                             # fan_in d_model
    assert abs(float(w1.std()) * cfg.d_model ** 0.5 - 1.0) < 0.05
    emb = a["tok"]["embedding"]                       # scale 1.0
    assert emb.shape == (cfg.vocab_padded(), cfg.d_model)
    assert abs(float(emb.std()) - 1.0) < 0.05


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("seq_len", [7, 40])
def test_frontend_shape_matches_reference(arch, seq_len):
    _, cfg = _cfgs(arch)
    jcfg = j_reduced(j_get_config(arch))
    assert frontend_shape(cfg, B, seq_len) == \
        j_frontend_shape(jcfg, B, seq_len)


def test_frontend_stubs_are_seeded_and_shaped():
    """The stubs draw from the generator they are given: the same seed,
    the same embeddings; the vision stub's patches carry their anyres
    tile offset, the audio stub's frames the smoothing over time."""
    cfgs = {f: reduced(get_config(a)) for f, a in (
        ("vision", "llava-next-mistral-7b"),
        ("audio", "seamless-m4t-medium"))}
    for f, cfg in cfgs.items():
        make = ((lambda g: vision_stub(cfg, B, g)) if f == "vision" else
                (lambda g: audio_stub(cfg, B, SE, g)))
        a, b = (make(torch.Generator().manual_seed(3)) for _ in range(2))
        assert a.shape == frontend_shape(cfg, B, SE)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        x = torch.randn(a.shape, generator=torch.Generator().manual_seed(3))
        if f == "audio":
            want = 0.5 * (x + torch.roll(x, 1, dims=1))
        else:                  # 8 patches: one tile, offset 0.1 * tile id
            tile = torch.arange(a.shape[1]) // a.shape[1]
            want = x + 0.1 * tile[None, :, None]
        torch.testing.assert_close(a, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="audio"):
        audio_stub(cfgs["vision"], B, SE, torch.Generator())
    with pytest.raises(ValueError, match="vision"):
        vision_stub(cfgs["audio"], B, torch.Generator())


def test_encdec_prefill_keeps_token_embeddings():
    """The audio frames are the encoder's input only: the decoder's token
    embeddings stay as they are (the vision stub's patches overwrite the
    first F positions); the encoder maps the frames to (B, Se, d)."""
    from repro_torch.models.transformer import _embed_inputs
    for arch in ("seamless-m4t-medium", "llava-next-mistral-7b"):
        cfg = reduced(get_config(arch))
        params = init_params(cfg, torch.Generator().manual_seed(0))
        toks = torch.randint(0, cfg.vocab_size, (B, SE),
                             generator=torch.Generator().manual_seed(1))
        fe = 0.1 * torch.ones((B, 4, cfg.d_model))
        x = _embed_inputs(params, cfg, toks, ModelOpts(), fe)
        want = params["tok"]["embedding"][toks]
        if cfg.family != "encdec":
            want = want.clone()
            want[:, :4] = fe
        torch.testing.assert_close(x, want, rtol=0, atol=0)
    cfg = reduced(get_config("seamless-m4t-medium"))
    params = init_params(cfg, torch.Generator().manual_seed(0))
    fe = audio_stub(cfg, B, SE, torch.Generator().manual_seed(2))
    assert encode(params, cfg, fe).shape == (B, SE, cfg.d_model)
    with pytest.raises(ValueError, match="encoder input"):
        logits_fn(params, cfg, toks)
    with pytest.raises(ValueError, match="fit"):        # Se > enc_len
        prefill(params, cfg, toks, init_cache(
            cfg, B, SE, enc_len=SE - 1, dtype=torch.float32, device="cpu"),
            frontend_embeds=fe)


def test_unknown_family_raises():
    cfg = dataclasses.replace(reduced(get_config("gemma3-1b")),
                              family="convnet")
    with pytest.raises(ValueError, match="unknown model family"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="unknown model family"):
        init_cache(cfg, 1, 4, device="cpu")


def test_attention_modes_agree_on_cpu():
    """Prefill through the op's 'auto' mode (the plain version on CPU
    tensors) equals 'ref' mode exactly; 'cuda' mode on CPU raises."""
    _, cfg = _cfgs("gemma3-1b")
    params = init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, 24),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for mode in ("auto", "ref"):
        cache = init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu")
        out[mode], _ = prefill(params, cfg, toks, cache,
                               opts=ModelOpts(attn_mode=mode))
    torch.testing.assert_close(out["auto"], out["ref"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        prefill(params, cfg, toks, init_cache(cfg, 1, 24, device="cpu"),
                opts=ModelOpts(attn_mode="cuda"))
