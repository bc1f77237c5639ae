"""The port's cell planner against the reference's: the twins of
tests/test_launch_plans.py (plan or skip every arch x shape x pod count,
every planned tensor's spec dividing it, the skip set and its reason
text), the factored optimizer state's shapes against the reference's
``opt_structs``, and the grouped layer checkpoint (``scan_groups`` > 1):
bit-equal to ``scan_groups=1`` on the CPU, and within 1e-4 (relative;
loss, grad norm and parameters after one step, f32, sums in other
orders) of the reference's grouped step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.configs.base import SHAPES
from repro.configs.registry import list_archs
from repro.data import FrontendPipeline as JFrontendPipeline
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch import specs as JS
from repro.models import ModelOpts as JModelOpts
from repro.models import init_params as j_init_params
from repro.models.sharding import make_rules as j_make_rules
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt as j_init_opt
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.launch.mesh import axis_sizes, make_production_mesh
from repro_torch.launch.specs import (POLICIES, ArchPolicy, Planned, Skip,
                                      opt_structs, plan_cell,
                                      planned_leaves, policy_for)
from repro_torch.models import params_from_jax, params_to_numpy
from repro_torch.models.convert import STACKED
from repro_torch.models.sharding import make_rules
from repro_torch.models.transformer import ModelOpts, init_params
from repro_torch.optim import OptConfig, init_opt
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.trainer import compute_grads
from repro_torch.utils import tree_leaves


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-4


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plan_or_skip(arch, shape, multi_pod):
    """A plan whose every planned tensor splits over the mesh as its spec
    says, or the reference's Skip with the reference's text."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        plan = plan_cell(arch, shape, mesh)
    except Skip as e:
        with pytest.raises(JS.Skip) as ref:
            JS.plan_cell(arch, shape, None)   # skips before any mesh use
        assert str(e) == str(ref.value)
        assert shape == "long_500k" and not get_config(arch).subquadratic
        return
    assert not (shape == "long_500k" and not get_config(arch).subquadratic)
    assert plan.kind == SHAPES[shape].kind
    leaves = planned_leaves(plan.args)
    assert leaves and all(isinstance(p, Planned) for p in leaves)
    sizes = axis_sizes(mesh)
    for p in leaves:
        assert p.tensor.is_meta
        local = p.local_shape(mesh)        # raises unless it divides
        used = [a for e in p.pspec for a in
                ((e,) if isinstance(e, str) else e or ())]
        assert len(used) == len(set(used)) and set(used) <= set(sizes)
        assert len(local) == len(p.shape)
    if plan.kind == "train":
        pol = POLICIES[arch]
        assert plan.note == (f"GA={pol.grad_accum} "
                             f"groups={pol.scan_groups}")
        assert plan.opts.scan_groups == pol.scan_groups
        assert plan.opts.remat == "full"
        ins = plan.args[2]
        assert ins["tokens"].shape == (SHAPES[shape].global_batch,
                                       SHAPES[shape].seq_len)


def test_skip_reasons_documented():
    skipped = [a for a in list_archs() if not get_config(a).subquadratic]
    assert sorted(skipped) == ["dbrx-132b", "llama3-405b",
                               "llava-next-mistral-7b",
                               "seamless-m4t-medium", "yi-34b"]


def test_policies_are_the_references():
    fields = ("grad_accum", "scan_groups", "loss_chunk", "factored_v",
              "cap_factor")
    assert set(POLICIES) == set(JS.POLICIES)
    for arch in list_archs():
        mine, ref = policy_for(arch), JS.policy_for(arch)
        assert [getattr(mine, f) for f in fields] == \
            [getattr(ref, f) for f in fields]
        for f in ("m_dtype", "v_dtype", "param_dtype"):
            assert str(getattr(mine, f)).split(".")[-1] == \
                jnp.dtype(getattr(ref, f)).name


class _FakeMesh:
    axis_names = ("data", "model")

    class devices:
        shape = (16, 16)


@pytest.mark.parametrize("arch", ["llama3-405b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_factored_opt_structs_match_reference(arch):
    """opt_structs under factored_v: the reference's r/c (and f) shapes
    on its stacked view, leaf for leaf; m per layer, the reference's
    stacked m cut by layer."""
    jpol, pol = JS.ArchPolicy(factored_v=True), ArchPolicy(factored_v=True)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    ref = JS.opt_structs(j_get_config(arch), mesh,
                         j_make_rules(j_get_config(arch), _FakeMesh()), jpol)
    mine = opt_structs(get_config(arch), _FakeMesh(),
                       make_rules(get_config(arch), _FakeMesh()), pol)
    flat = jax.tree_util.tree_flatten_with_path(ref["v"])[0]
    assert len(flat) == len(planned_leaves(mine["v"]))
    for path, s in flat:
        got = mine["v"]
        for k in path:
            got = got[k.key]
        assert got.shape == tuple(s.shape), jax.tree_util.keystr(path)
    for path, s in jax.tree_util.tree_flatten_with_path(ref["m"])[0]:
        keys = [k.key for k in path]
        if keys[0] in STACKED:
            layers = mine["m"][keys[0]]
            assert len(layers) == s.shape[0]
            for layer in layers:
                got = layer
                for k in keys[1:]:
                    got = got[k]
                assert got.shape == tuple(s.shape[1:])
        else:
            got = mine["m"]
            for k in keys:
                got = got[k]
            assert got.shape == tuple(s.shape)
    assert mine["step"].shape == ()


# ---------------------------------------------------------------------------
# The grouped layer checkpoint
# ---------------------------------------------------------------------------
def _batch(cfg, batch=2, seq=32, step=0):
    b = JTokenPipeline(cfg.vocab_size, batch, seq, seed=0).batch_at(step)
    if cfg.frontend:
        frames = cfg.frontend_tokens if cfg.frontend == "vision" else seq
        b["frontend"] = JFrontendPipeline(cfg.d_model, frames,
                                          seed=0).batch_at(step, batch)
    return b


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b",
                                  "mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_grouped_checkpoint_bit_equal(arch):
    """scan_groups 2 (two groups of 2 blocks over the reduced archs' 4
    layers; the hybrid's groups whatever) gives the same loss and
    gradients bit for bit as scan_groups 1."""
    cfg = reduced(get_config(arch))
    b = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    out = []
    for g in (1, 2):
        params = init_params(cfg, torch.Generator().manual_seed(0))
        loss, _, grads = compute_grads(params, cfg, b, TrainConfig(),
                                       ModelOpts(loss_chunk=16,
                                                 scan_groups=g))
        out.append((loss, tree_leaves(grads)))
    for loss, grads in out[1:]:
        assert torch.equal(loss, out[0][0])
        assert all(torch.equal(a, c) for a, c in zip(grads, out[0][1]))


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b"])
def test_grouped_step_matches_reference(arch):
    """One train step at scan_groups=2 in both packages from the same
    parameters and batch: loss, grad norm and every parameter."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    kw = dict(lr_max=1e-3, warmup=2, decay_steps=10)
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                             device="cpu")
    jstep = jax.jit(j_make_train_step(
        jcfg, JOptConfig(**kw), JTrainConfig(),
        opts=JModelOpts(remat="full", scan_groups=2, loss_chunk=32)))
    step = make_train_step(cfg, OptConfig(**kw), TrainConfig(),
                           opts=ModelOpts(scan_groups=2, loss_chunk=32))
    b = _batch(cfg, batch=4, seq=64)
    jparams, _, jm = jstep(jparams, j_init_opt(jparams, JOptConfig(**kw)),
                           {k: jnp.asarray(v) for k, v in b.items()})
    params, _, m = step(params, init_opt(params, OptConfig(**kw)),
                        {k: torch.as_tensor(v) for k, v in b.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            RTOL * abs(float(jm[key])), key
    mine = params_to_numpy(params)
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax.tree_util.tree_map(np.asarray, jparams))[0]:
        got = mine
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))
