"""The port's checkpoints and restart supervisor: the twins of
tests/test_checkpoint_ft.py (round trip and keep-k, an uncommitted save
invisible, restore onto a chosen device in place of the elastic
re-shard, the supervisor's recovery and its exhaustion), and the
cross-package check: a checkpoint the reference's trainer wrote restores
in the port and the port's next step equals the reference's next step,
and the reverse.

Tolerances: round trips bit for bit; next steps across the packages:
loss and grad norm within 1e-4 relative, parameters within 1e-4 (atol
and rtol), as tests/test_torch_train.py.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as j_ckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import ModelOpts as JModelOpts
from repro.models import init_params as j_init_params
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt as j_init_opt
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.ft.restart import run_with_restarts
from repro_torch.models.transformer import ModelOpts
from repro_torch.optim import OptConfig
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.trainer import load_state, state_like, state_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-4


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.tensor(rng.standard_normal(
                (16, 8), dtype=np.float32)),
                       "b": torch.zeros(8)},
            "opt": {"m": torch.tensor(rng.standard_normal(
                (16, 8), dtype=np.float32)),
                    "step": torch.tensor(3, dtype=torch.int32)},
            "blocks": [torch.ones(2), torch.full((3,), 2.0)]}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def test_roundtrip_and_keep_k(tmp_path):
    d = str(tmp_path)
    t = _tree(0)
    for s in (10, 20, 30, 40):
        ckpt.save(d, s, t, keep=2)
    assert ckpt.all_steps(d) == [30, 40]
    step, restored, extra = ckpt.restore(d, t)
    assert step == 40 and extra == {}
    for a, b in zip(_leaves(restored), _leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the reference's key names: paths joined by "::", list positions
    with np.load(os.path.join(d, "step_00000040", "shard-0.npz")) as z:
        assert sorted(z.files) == ["blocks::0", "blocks::1", "opt::m",
                                   "opt::step", "params::b", "params::w"]


def test_uncommitted_checkpoint_invisible(tmp_path):
    d = str(tmp_path)
    t = _tree(1)
    ckpt.save(d, 10, t)
    # a crash mid-save of step 20: shard written, META missing
    sdir = os.path.join(d, "step_00000020")
    os.makedirs(sdir)
    with open(os.path.join(sdir, "shard-0.npz"), "wb") as f:
        f.write(b"partial garbage")
    assert ckpt.latest_step(d) == 10
    step, _, _ = ckpt.restore(d, t)
    assert step == 10


def test_restore_onto_chosen_device(tmp_path):
    """Restore onto a given device (the port's stand-in for the elastic
    re-shard), from a like tree of shapes and dtypes alone ("meta"
    tensors); numpy leaves of like come back as numpy."""
    d = str(tmp_path)
    t = _tree(2)
    ckpt.save(d, 5, t, extra={"note": "x"})
    like = {"params": {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                       for k, v in t["params"].items()},
            "opt": {"m": np.zeros((16, 8), np.float32),
                    "step": torch.empty((), dtype=torch.int32,
                                        device="meta")},
            "blocks": [torch.empty(2, device="meta"),
                       torch.empty(3, device="meta")]}
    step, restored, extra = ckpt.restore(d, like, device="cpu")
    assert step == 5 and extra == {"note": "x"}
    assert restored["params"]["w"].device == torch.device("cpu")
    assert isinstance(restored["opt"]["m"], np.ndarray)
    np.testing.assert_array_equal(restored["opt"]["m"], t["opt"]["m"])
    assert torch.equal(restored["params"]["w"], t["params"]["w"])
    bad = dict(like, blocks=[torch.empty(3, device="meta"),
                             torch.empty(3, device="meta")])
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, bad, device="cpu")
    with pytest.raises(KeyError, match="missing"):
        ckpt.restore(d, dict(like, extra_leaf=torch.empty(1)), device="cpu")


def test_restart_supervisor_recovers(tmp_path):
    d = str(tmp_path)
    fails = {"left": 2}

    def restore_state(latest):
        _, tree, _ = ckpt.restore(d, {"acc": np.int64(0)})
        return latest, np.int64(tree["acc"])

    def fail_injector(step):
        if step == 7 and fails["left"] > 0:
            fails["left"] -= 1
            raise RuntimeError("injected node failure")

    waits = []
    step, acc, stats = run_with_restarts(
        init_state=lambda: (0, np.int64(0)), restore_state=restore_state,
        run_step=lambda step, acc: acc + step,
        save_state=lambda step, acc: ckpt.save(d, step,
                                               {"acc": np.int64(acc)}),
        total_steps=12, ckpt_dir=d, ckpt_every=5, max_restarts=5,
        fail_injector=fail_injector, sleep_fn=waits.append)
    assert step == 12 and stats.restarts == 2
    assert acc == sum(range(12))   # deterministic replay -> exact result
    assert stats.steps_replayed == 4 and len(waits) == 2


def test_restart_exhaustion_raises(tmp_path):
    def boom(step):
        raise RuntimeError("always fails")

    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        run_with_restarts(
            init_state=lambda: (0, 0), restore_state=lambda s: (s, 0),
            run_step=lambda s, st: boom(s), save_state=lambda s, st: None,
            total_steps=5, ckpt_dir=str(tmp_path), max_restarts=2,
            sleep_fn=lambda s: None)


ARCH = "gemma3-1b"
OC = dict(lr_max=1e-3, warmup=2, decay_steps=10)


@pytest.fixture(scope="module")
def steps():
    """Both packages' train steps for reduced gemma3-1b, and a batch
    source."""
    jcfg, cfg = j_reduced(j_get_config(ARCH)), reduced(get_config(ARCH))
    jstep = jax.jit(j_make_train_step(
        jcfg, JOptConfig(**OC), JTrainConfig(),
        opts=JModelOpts(remat="full", loss_chunk=32)))
    step = make_train_step(cfg, OptConfig(**OC), TrainConfig(),
                           opts=ModelOpts(loss_chunk=32))
    pipe = JTokenPipeline(cfg.vocab_size, 4, 64, seed=0)
    return jcfg, cfg, jstep, step, pipe


def _port_state(cfg):
    return init_train_state(cfg, OptConfig(**OC),
                            torch.Generator().manual_seed(9))


def _next_steps(jstep, step, jstate, state, batch):
    jp, jo, jm = jstep(*jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    p, o, m = step(*state, {k: torch.as_tensor(v) for k, v in batch.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            RTOL * abs(float(jm[key])), key
    mine = state_tree(p, o)
    ref = {"params": jax.tree_util.tree_map(np.asarray, jp),
           "opt": jax.tree_util.tree_map(np.asarray, jo)}
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, want in flat:
        got = mine
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL,
                                   err_msg=jax.tree_util.keystr(path))
    assert int(mine["opt"]["step"]) == int(ref["opt"]["step"])


def test_reference_checkpoint_restores_in_port(tmp_path, steps):
    """The reference trains two steps and saves as its launch/train.py
    does; the port restores it (state_like, load_state) and its third
    step equals the reference's third step."""
    jcfg, cfg, jstep, step, pipe = steps
    jp = j_init_params(jcfg, jax.random.PRNGKey(3))
    jo = j_init_opt(jp, JOptConfig(**OC))
    for s in range(2):
        jp, jo, _ = jstep(jp, jo, {k: jnp.asarray(v)
                                   for k, v in pipe.batch_at(s).items()})
    j_ckpt.save(str(tmp_path), 2, {"params": jp, "opt": jo})
    params, opt = _port_state(cfg)
    st, tree, _ = ckpt.restore(str(tmp_path), state_like(params, opt),
                               device="cpu")
    load_state(params, opt, tree)
    assert st == 2 and int(opt["step"]) == 2
    _next_steps(jstep, step, (jp, jo), (params, opt), pipe.batch_at(2))


def test_port_checkpoint_restores_in_reference(tmp_path, steps):
    """The reverse: the port trains two steps and saves its state tree;
    the reference restores it into its own tree and its third step
    equals the port's third step."""
    jcfg, cfg, jstep, step, pipe = steps
    params, opt = _port_state(cfg)
    for s in range(2):
        params, opt, _ = step(params, opt, {
            k: torch.as_tensor(v) for k, v in pipe.batch_at(s).items()})
    ckpt.save(str(tmp_path), 2, state_tree(params, opt))
    jp = j_init_params(jcfg, jax.random.PRNGKey(0))
    st, tree, _ = j_ckpt.restore(str(tmp_path), {
        "params": jp, "opt": j_init_opt(jp, JOptConfig(**OC))})
    assert st == 2 and int(tree["opt"]["step"]) == 2
    _next_steps(jstep, step, (tree["params"], tree["opt"]), (params, opt),
                pipe.batch_at(2))
