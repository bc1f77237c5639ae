"""The port's trainer on the CPU: the twins of tests/test_train.py (loss
decreases, grad-accum equivalence, NaN-guard skip-step, the data
pipeline), and parity with the reference's train step on the same numpy
parameters (``params_from_jax``) and batches.

Tolerances: the reference's own where a test is its twin (loss 2e-4,
grad norm 2e-3 relative, parameters rtol 1e-4 / atol 1e-5 across
grad-accum); against the reference's step, loss and global grad norm
within 1e-4 relative and parameters after 3 steps within 1e-4 (atol and
rtol): f32 on both sides, sums in other orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import FrontendPipeline as JFrontendPipeline
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import ModelOpts as JModelOpts
from repro.models import init_params as j_init_params
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt as j_init_opt
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
from repro_torch.models import params_from_jax, params_to_numpy
from repro_torch.models.transformer import ModelOpts
from repro_torch.optim import OptConfig, init_opt
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.trainer import state_tree
from repro_torch.utils import as_tree, tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = reduced(get_config("gemma3-1b"))
OPTS = ModelOpts(remat="full", loss_chunk=32)
PARITY_RTOL = 1e-4


def _pipe(batch=8, seq=64):
    return TokenPipeline(CFG.vocab_size, batch, seq, seed=0)


def _batch(pipe, step):
    return {k: torch.as_tensor(v) for k, v in pipe.batch_at(step).items()}


def _init(seed=0):
    return init_train_state(CFG, OptConfig(),
                            torch.Generator().manual_seed(seed))[0]


def test_loss_decreases():
    oc = OptConfig(lr_max=3e-3, warmup=5, decay_steps=60)
    step = make_train_step(CFG, oc, TrainConfig(), opts=OPTS)
    pipe = _pipe()
    params = _init()
    opt = init_opt(params, oc)
    losses = []
    for s in range(25):
        params, opt, m = step(params, opt, _batch(pipe, s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_grad_accum_equivalent():
    """GA=2 and 4 match GA=1 on the same global batch (reported loss and
    grad_norm, and the parameters after the step)."""
    oc = OptConfig(lr_max=1e-3, warmup=1, decay_steps=10)
    b = _batch(_pipe(batch=8), 0)
    init = params_to_numpy(_init(1))
    outs = {}
    for ga in (1, 2, 4):
        step = make_train_step(CFG, oc, TrainConfig(grad_accum=ga),
                               opts=OPTS)
        params = params_from_jax(CFG, init, device="cpu")
        p2, _, m = step(params, init_opt(params, oc), b)
        outs[ga] = (float(m["loss"]), float(m["grad_norm"]),
                    tree_leaves(as_tree(p2))[0].detach().numpy().copy())
    for ga in (2, 4):
        assert abs(outs[ga][0] - outs[1][0]) < 2e-4
        assert abs(outs[ga][1] - outs[1][1]) / outs[1][1] < 2e-3
        np.testing.assert_allclose(outs[ga][2], outs[1][2], rtol=1e-4,
                                   atol=1e-5)


def test_nan_guard_skips_update():
    oc = OptConfig(lr_max=1e-3, warmup=1, decay_steps=10)
    step = make_train_step(CFG, oc, TrainConfig(), opts=OPTS)
    params = _init()
    with torch.no_grad():
        for p in params.parameters():
            p.view(-1)[0] = float("nan")
    before = [p.detach().clone() for p in params.parameters()]
    opt = init_opt(params, oc)
    p2, o2, m = step(params, opt, _batch(_pipe(), 0))
    assert int(m["skipped"]) == 1 and m["skipped"].dtype == torch.int32
    # parameters and moments unchanged, step counter advanced
    for a, b in zip(p2.parameters(), before):
        torch.testing.assert_close(a.detach(), b, equal_nan=True, rtol=0,
                                   atol=0)
    for a, b in zip(tree_leaves(o2["m"]), tree_leaves(opt["m"])):
        assert torch.equal(a, b)
    assert int(o2["step"]) == 1


def test_pipeline_deterministic_sharded_and_the_references():
    pipe = _pipe(batch=8)
    a, b = pipe.batch_at(7), pipe.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = pipe.batch_at(8)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # labels are next-token
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    # host slicing partitions the global batch
    h0, h1 = pipe.host_slice(7, 0, 2), pipe.host_slice(7, 1, 2)
    np.testing.assert_array_equal(
        np.concatenate([h0["tokens"], h1["tokens"]]), a["tokens"])
    # the reference's batches, bit for bit
    ref = JTokenPipeline(CFG.vocab_size, 8, 64, seed=0).batch_at(7)
    for k in ("tokens", "labels"):
        assert a[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(a[k], ref[k])
    np.testing.assert_array_equal(
        FrontendPipeline(16, 8, seed=3).batch_at(5, 2),
        JFrontendPipeline(16, 8, seed=3).batch_at(5, 2))


def test_remat_none_equals_full():
    """remat changes what is kept for the backward, not the numbers
    (none, full and the reference's "dots" policy:
    tests/test_torch_remat_dots.py holds dots to full bit for bit); an
    unknown policy is refused, and so is a group count below one
    (scan_groups > 1 is ported: tests/test_torch_specs.py)."""
    b = _batch(_pipe(batch=4, seq=32), 0)
    init = params_to_numpy(_init(2))
    out = {}
    for remat in ("none", "full", "dots"):
        params = params_from_jax(CFG, init, device="cpu")
        step = make_train_step(CFG, OptConfig(), TrainConfig(),
                               opts=ModelOpts(remat=remat, loss_chunk=16))
        _, _, m = step(params, init_opt(params, OptConfig()), b)
        out[remat] = (float(m["loss"]), float(m["grad_norm"]))
    assert out["none"] == pytest.approx(out["full"], rel=1e-6)
    assert out["dots"] == out["full"]
    with pytest.raises(ValueError, match="dots"):
        ModelOpts(remat="selective")
    with pytest.raises(ValueError, match="scan_groups"):
        ModelOpts(scan_groups=0)


def _family_batch(cfg, step, batch, seq):
    b = JTokenPipeline(cfg.vocab_size, batch, seq, seed=0).batch_at(step)
    if cfg.frontend:
        frames = cfg.frontend_tokens if cfg.frontend == "vision" else seq
        b["frontend"] = JFrontendPipeline(cfg.d_model, frames,
                                          seed=0).batch_at(step, batch)
    return b


def _parity(arch, steps, batch=4, seq=64):
    """The reference's and the port's train steps from the same numpy
    parameters over the same batches: per step (loss, grad norm) of
    both, and both final parameter trees as numpy (reference layout)."""
    rows, (jparams, _), (params, _) = _run_parity(arch, steps, batch, seq)
    return rows, jparams, params


def _run_parity(arch, steps, batch=4, seq=64, factored=False):
    """:func:`_parity`'s run, returning both final (parameters,
    optimizer state) pairs: the reference's as numpy trees, the port's
    as its state_tree (the reference's layout)."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    kw = dict(lr_max=1e-3, warmup=2, decay_steps=10, factored_v=factored)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                             device="cpu")
    jstep = jax.jit(j_make_train_step(
        jcfg, JOptConfig(**kw), JTrainConfig(),
        opts=JModelOpts(remat="full", loss_chunk=32)))
    step = make_train_step(cfg, OptConfig(**kw), TrainConfig(),
                           opts=ModelOpts(loss_chunk=32))
    jopt, opt = j_init_opt(jparams, JOptConfig(**kw)), init_opt(
        params, OptConfig(**kw))
    rows = []
    for s in range(steps):
        b = _family_batch(cfg, s, batch, seq)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt,
                              {k: torch.as_tensor(v) for k, v in b.items()})
        rows.append(((float(jm["loss"]), float(jm["grad_norm"])),
                     (float(m["loss"]), float(m["grad_norm"]))))
    mine = state_tree(params, opt)
    return rows, (jax.tree_util.tree_map(np.asarray, jparams),
                  jax.tree_util.tree_map(np.asarray, jopt)), \
        (params_to_numpy(params), mine["opt"])


def _check_rows(rows):
    for (jl, jg), (pl, pg) in rows:
        assert abs(pl - jl) <= PARITY_RTOL * abs(jl), (pl, jl)
        assert abs(pg - jg) <= PARITY_RTOL * abs(jg), (pg, jg)


@pytest.mark.parametrize("arch", ["gemma3-1b", "gemma2-27b"])
def test_train_steps_match_reference(arch):
    """Three steps from the same parameters and batches: loss and grad
    norm per step, then every parameter (gemma2: attention and final
    logit softcaps)."""
    rows, jparams, params = _parity(arch, 3)
    _check_rows(rows)
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert len(flat) == len(tree_leaves(params))
    for path, want in flat:
        got = params
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=PARITY_RTOL,
                                   atol=PARITY_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["gemma3-1b", "zamba2-1.2b"])
def test_factored_steps_match_reference(arch):
    """The factored second moment (ROADMAP C1): three steps of both
    packages with factored_v, loss and grad norm per step and every
    parameter within 1e-4; state_tree's optimizer state has the
    reference's structure (a per-layer norm scale's v is {"r": (L,),
    "c": (d,)}) and its values (m and the factored statistics within
    1e-4 relative, the step equal)."""
    rows, (jparams, jopt), (params, opt) = _run_parity(arch, 3,
                                                       factored=True)
    _check_rows(rows)
    for ref, mine in ((jparams, params), (jopt, opt)):
        flat = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert len(flat) == len(jax.tree_util.tree_leaves(mine))
        for path, want in flat:
            got = mine
            for key in path:
                got = got[key.key]
            assert got.shape == want.shape, jax.tree_util.keystr(path)
            np.testing.assert_allclose(
                got, want, rtol=PARITY_RTOL,
                atol=PARITY_RTOL * float(np.abs(want).max(initial=0.0)),
                err_msg=jax.tree_util.keystr(path))
    L = reduced(get_config(arch)).num_layers
    d = reduced(get_config(arch)).d_model
    assert {k: v.shape for k, v in opt["v"]["blocks"]["ln1"]["scale"]
            .items()} == {"r": (L,), "c": (d,)}
