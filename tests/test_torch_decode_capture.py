"""The port's serving decode in the reference's execution model: the
cache's ``pos`` and ``enc_len`` are 0-d int32 device tensors, and
``launch/serve.py``'s session (``make_step_fns``) runs ``decode_step``
as one program of ``core.capture.CACHE``, captured once per session and
replayed per token on a card. On the CPU the cache's entry runs the
step eagerly into the same static buffers, after the same warm-up, so
these tests see the card's semantics: for a reduced arch of every
serving family the captured path's greedy tokens and logits equal
``capture=False``'s bit for bit; the scalars equal the reference's
cache scalars; the first captured step steps the SSM and conv states
once (the warm-up leaves them as it found them); one ``decode_step``
build covers a warm-up and a timed generation, and a session's end
drops its entries; and the trace-discipline lint reaches the decode
step (a sync or a tensor branch seeded there fails it). The greedy
tokens against the reference's jitted ``greedy_generate`` are
tests/test_torch_serve.py's, which run this captured path."""
import io
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import ModelOpts as JOpts
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import prefill as j_prefill
from repro_torch.analysis.capture_guard import CaptureGuard
from repro_torch.analysis.lint import run_lint
from repro_torch.configs import get_config, reduced
from repro_torch.core.capture import CACHE, tree_leaves
from repro_torch.launch.serve import greedy_generate, make_step_fns
from repro_torch.models import params_to_numpy
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_shape

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
LINT_BASELINE = PKG / "analysis" / "lint_baseline.json"

ARCHS = ["gemma3-1b", "mixtral-8x7b", "mamba2-780m", "zamba2-1.2b",
         "seamless-m4t-medium"]
B, SP, GEN = 2, 14, 5        # positions up to 18: past the reduced window


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(arch, seed=0):
    """(cfg, params, prompt tokens, frontend input, encoder length) of the
    reduced arch, drawn from ``seed`` on the CPU."""
    cfg = reduced(get_config(arch))
    gen = torch.Generator().manual_seed(seed)
    params = T.init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (B, SP), generator=gen)
    shape = frontend_shape(cfg, B, SP)
    fe = None if shape is None else 0.05 * torch.randn(shape, generator=gen)
    return cfg, params, toks, fe, SP if cfg.frontend == "audio" else 0


@pytest.mark.parametrize("arch", ARCHS)
def test_captured_decode_equals_eager_bit_for_bit(arch):
    cfg, params, toks, fe, enc_len = _inputs(arch)
    opts = T.ModelOpts()
    runs = {}
    for capture in (True, False):
        stats = {}
        with make_step_fns(cfg, opts, capture=capture) as fns, \
                CaptureGuard() as cg:
            out = greedy_generate(params, cfg, toks, gen=GEN, opts=opts,
                                  frontend_embeds=fe, enc_len=enc_len,
                                  step_fns=fns, stats=stats,
                                  keep_logits=True)
        assert cg.count("decode_step") == (1 if capture else 0)
        assert stats["logits_finite"]
        runs[capture] = out, stats["logits"]
    assert runs[True][0].shape == (B, GEN)
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])


def test_cache_scalars_are_the_references():
    """seamless (both scalars, an encoder cache longer than its frames):
    ``pos`` and ``enc_len`` are 0-d int32 tensors on the cache's device,
    equal to the reference's after prefill and after each captured
    decode step, and the logits agree within 1e-4."""
    arch, sp, se, enc_rows = "seamless-m4t-medium", 6, 4, 6
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(params))
    jopts = JOpts(remat="none")
    j_pre = jax.jit(lambda p, t, c, fe: j_prefill(p, jcfg, t, c, opts=jopts,
                                                  frontend_embeds=fe))
    j_dec = jax.jit(lambda p, c, t: j_decode_step(p, jcfg, c, t, opts=jopts))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (B, sp + 2)).astype(np.int32)
    fe = (0.1 * rng.standard_normal((B, se, cfg.d_model))).astype(np.float32)
    jcache = j_init_cache(jcfg, B, sp + 2, enc_len=enc_rows,
                          dtype=jnp.float32)
    jl, jcache = j_pre(jparams, jnp.asarray(toks[:, :sp]), jcache,
                       jnp.asarray(fe))
    tt = torch.from_numpy(toks).long()
    with make_step_fns(cfg, T.ModelOpts()) as fns:
        cache = fns.cache(B, sp + 2, enc_rows, "cpu")
        for name in ("pos", "enc_len"):
            assert cache[name].shape == () and \
                cache[name].dtype == torch.int32
        lg, cache = fns.prefill(params, tt[:, :sp], cache,
                                torch.from_numpy(fe))
        for t in range(2):
            np.testing.assert_allclose(lg.numpy(), np.asarray(jl),
                                       rtol=1e-4, atol=1e-4)
            for name in ("pos", "enc_len"):
                got, want = cache[name], jcache[name]
                assert got.shape == want.shape == ()
                assert got.dtype == torch.int32 and want.dtype == jnp.int32
                assert int(got) == int(want), (name, t)
            assert int(cache["pos"]) == sp + t and \
                int(cache["enc_len"]) == se
            if t < 1:
                step = toks[:, sp + t:sp + t + 1]
                jl, jcache = j_dec(jparams, jcache, jnp.asarray(step))
                lg, cache = fns.decode(params, cache,
                                       torch.from_numpy(step))


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-1.2b"])
def test_first_captured_step_steps_the_state_once(arch):
    """After prefill and one decode step through the session (its entry
    built on that step, the warm-up included), the SSM and conv states,
    the KV cache and ``pos`` equal those of one plain ``decode_step`` on
    a fresh cache, bit for bit: the capture's warm-up does not step the
    recurrence a second time."""
    cfg, params, toks, fe, _ = _inputs(arch, seed=1)
    nxt = toks[:, -1:].to(torch.int32)
    cache = T.init_cache(cfg, B, SP + 2, enc_len=1, dtype=torch.float32,
                         device="cpu")
    _, cache = T.prefill(params, cfg, toks, cache)
    want_lg, want = T.decode_step(params, cfg, cache, nxt)
    with make_step_fns(cfg, T.ModelOpts()) as fns, CaptureGuard() as cg:
        got = fns.cache(B, SP + 2, 1, "cpu")
        _, got = fns.prefill(params, toks, got, None)
        lg, got = fns.decode(params, got, nxt)
        assert cg.count("decode_step") == 1
        assert torch.equal(lg, want_lg)
        assert sorted(got) == sorted(want)
        for name in want:
            for g, w in zip(*(x if isinstance(x, list) else [x]
                              for x in (got[name], want[name]))):
                assert torch.equal(g, w), name
        assert int(got["pos"]) == SP + 1


def test_one_decode_capture_per_session():
    """A warm-up generation builds the session's ``decode_step`` entry and
    a timed generation of the same shapes only replays it, on the same
    cache tensors (zeroed in place between generations: the two give
    the same tokens); the session's end drops its entries, and a new
    session builds its own. Without a session ``greedy_generate`` is a
    session of its own and leaves no entry behind."""
    cfg, params, toks, fe, enc_len = _inputs("gemma3-1b", seed=2)
    opts = T.ModelOpts()
    before = CACHE.count("decode_step")
    with make_step_fns(cfg, opts) as fns:
        with CaptureGuard() as cg:
            warm = greedy_generate(params, cfg, toks, gen=2, opts=opts,
                                   step_fns=fns, cache_len=SP + GEN)
            ptrs = [t.data_ptr() for t in
                    tree_leaves(fns.caches)]
            out = greedy_generate(params, cfg, toks, gen=GEN, opts=opts,
                                  step_fns=fns)
            again = greedy_generate(params, cfg, toks, gen=GEN, opts=opts,
                                    step_fns=fns)
        assert cg.count("decode_step") == 1 and cg.total == 1
        assert len(fns.caches) == 1
        assert ptrs == [t.data_ptr() for t in
                        tree_leaves(fns.caches)]
        assert torch.equal(out, again) and torch.equal(out[:, :2], warm)
        assert CACHE.count("decode_step") == before + 1
    assert CACHE.count("decode_step") == before and not fns.caches
    with make_step_fns(cfg, opts) as fns, CaptureGuard() as cg:
        greedy_generate(params, cfg, toks, gen=2, opts=opts, step_fns=fns)
        assert cg.count("decode_step") == 1
    with CaptureGuard() as cg:
        alone = greedy_generate(params, cfg, toks, gen=GEN, opts=opts)
    assert cg.count("decode_step") == 1 and torch.equal(alone, out)
    assert CACHE.count("decode_step") == before


# A device read or a tensor branch seeded into a function the captured
# decode step reaches (through ``T.decode_step`` in launch/serve.py, then
# the models' modules) must turn the committed-tree lint red.
DECODE_SEEDS = {
    "attention_sync": ("models/attention.py", "NDS003",
                       '    scale = cfg.head_dim ** -0.5\n'
                       '    y = attn_direct(q, cache_k',
                       '    scale = cfg.head_dim ** -0.5\n'
                       '    scale = scale * float(torch.sum(q))\n'
                       '    y = attn_direct(q, cache_k'),
    "ssm_branch": ("models/ssm.py", "NDS002",
                   '    A = -torch.exp(p["A_log"].float())\n',
                   '    A = -torch.exp(p["A_log"].float())\n'
                   '    if torch.any(A > 0):\n'
                   '        A = -A\n'),
    "moe_sync": ("models/moe.py", "NDS003",
                 '    cap = capacity(xt.shape[0], cfg, capacity_factor)\n',
                 '    cap = capacity(xt.shape[0], cfg, capacity_factor)\n'
                 '    cap = cap + int(torch.max(top_e))\n'),
}


@pytest.mark.parametrize("seed", sorted(DECODE_SEEDS))
def test_lint_reaches_the_decode_step(tmp_path, seed):
    rel, rule, old, new = DECODE_SEEDS[seed]
    tree = tmp_path / "repro_torch"
    shutil.copytree(PKG, tree,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    path = tree / rel
    src = path.read_text()
    assert src.count(old) == 1, seed
    path.write_text(src.replace(old, new))
    out = io.StringIO()
    assert run_lint([tree], baseline_path=LINT_BASELINE, out=out) != 0
    assert rule in out.getvalue(), out.getvalue()
