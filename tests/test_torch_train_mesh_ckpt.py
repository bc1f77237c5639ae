"""Checkpoints of the sharded step and its factored second moment.

Checkpoints: a run at (data, model) = (2, 2) saves after 2 steps (rank
0 writes the gathered state in the one-device layout); a restart at (2,
2) from it is bit-equal to the unbroken run; the port on one device and
the reference restore it (the arrays bit for bit) and take the third
step within the parity tolerances of the mesh's third step; checkpoints
the port wrote on one device and the reference wrote restore at (2,
2), their shards bit for bit, and the mesh's third step agrees with
the writer's third step. Reduced gemma3-1b, batch 4 x 32, loss chunk
32, remat full. A reduced zamba2-1.2b checkpoint written at (2, 2),
where the SSD's d_inner and the shared block's heads split, restores
at (1, 1) and on one device, and both continue for 2 steps within 1e-5
of the unbroken (2, 2) run.

Factored v (``OptConfig(factored_v=True)``, the reference's
Adafactor-style second moment): 3 steps at (2, 1) (FSDP cuts every
leaf's "embed" dim) and (1, 2) (the heads, d_ff and vocab split) against
the reference's sharded factored step, with the gates of
tests/test_torch_train_mesh.py; the row and column statistics of a cut
dim are all-reduced (tag "factored").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_train_mesh_ranks as ranks
from repro import checkpoint as j_ckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import ModelOpts as JModelOpts
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt as j_init_opt
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.models import params_from_jax
from repro_torch.optim import init_opt
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.trainer import (load_state, state_like, state_tree,
                                       trainable)
from torch_train_mesh_ranks import _leaves, check_params, check_steps

_one_torch_thread = ranks.one_torch_thread()
ARCH = "gemma3-1b"
CASE = dict(arch=ARCH, steps=3, batch=4, seq=32, stats_step=1)
#: the hybrid checkpoint: written at (2, 2) after 2 of 4 steps
HYBRID = dict(CASE, arch="zamba2-1.2b", steps=4)
FACTORED = {"f21": (ARCH, (2, 1)), "f12": (ARCH, (1, 2))}


def one_device_state(init, steps):
    cfg, oc, opts = ranks.setup(CASE)
    params = trainable(params_from_jax(cfg, init, device="cpu"))
    opt = init_opt(params, oc)
    step = make_train_step(cfg, oc, TrainConfig(), opts=opts)
    ms = []
    for s in range(steps):
        params, opt, m = step(params, opt, ranks.batch_at(cfg, 4, 32, s))
        ms.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    return cfg, oc, opts, step, params, opt, ms


def reference_step():
    """The reference's unsharded train step (jit), as its launch/train.py
    builds it."""
    jcfg = j_reduced(j_get_config(ARCH))
    return jcfg, jax.jit(j_make_train_step(
        jcfg, JOptConfig(**ranks.OPT), JTrainConfig(),
        opts=JModelOpts(remat="full", loss_chunk=ranks.LOSS_CHUNK)))


def reference_batch(jcfg, step):
    return {k: jnp.asarray(v.numpy()) for k, v in
            ranks.batch_at(jcfg, 4, 32, step).items()}


@pytest.fixture(scope="module")
def ckpt_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh_ckpt")
    init = ranks.reference_init(ARCH)
    # the one-device checkpoint the mesh restores, and its third step
    cfg, oc, opts, step, params, opt, _ = one_device_state(init, 2)
    ckpt.save(str(tmp / "one_ckpt"), 2, state_tree(params, opt))
    params, opt, m = step(params, opt, ranks.batch_at(cfg, 4, 32, 2))
    unbroken_one = {"final": state_tree(params, opt)["params"],
                    "steps": [{k: float(m[k]) for k in
                               ("loss", "grad_norm")}]}
    # the reference's checkpoint after 2 steps, and its third step
    jcfg, jstep = reference_step()
    jp = jax.tree_util.tree_map(jnp.asarray, init)
    jo = j_init_opt(jp, JOptConfig(**ranks.OPT))
    for s in range(2):
        jp, jo, _ = jstep(jp, jo, reference_batch(jcfg, s))
    j_ckpt.save(str(tmp / "ref_ckpt"), 2, {"params": jp, "opt": jo})
    _, _, jm = jstep(jp, jo, reference_batch(jcfg, 2))
    w4 = tmp / "w4"
    zinit = ranks.reference_init(HYBRID["arch"])
    cases = [dict(HYBRID, name="zk_a", mesh=[2, 2], init=zinit, save_at=2),
             dict(CASE, name="ck_a", mesh=[2, 2], init=init, save_at=2),
             dict(CASE, name="ck_b", mesh=[2, 2], init=init,
                  restore=str(w4 / "ck_a_ckpt")),
             dict(CASE, name="ck_c", mesh=[2, 2], init=init,
                  restore=str(tmp / "one_ckpt")),
             dict(CASE, name="ck_d", mesh=[2, 2], init=init,
                  restore=str(tmp / "ref_ckpt"))]
    procs = ranks.start_ranks(cases, 4, w4)
    ranks.finish(procs, [str(w4 / f"rank{r}.log") for r in range(4)])
    got = ranks.rank_results(w4, 4)[0]
    w1 = tmp / "w1"
    procs = ranks.start_ranks([dict(HYBRID, name="zk_b", mesh=[1, 1],
                                    init=zinit,
                                    restore=str(w4 / "zk_a_ckpt"))], 1, w1)
    ranks.finish(procs, [str(w1 / "rank0.log")])
    got.update(ranks.rank_results(w1, 1)[0])
    return {"tmp": tmp, "got": got, "zinit": zinit,
            "one": unbroken_one, "init": init, "jstep": (jcfg, jstep),
            "ref_third": [{k: float(jm[k]) for k in ("loss", "grad_norm")}],
            "ref_state": {"params": jax.tree_util.tree_map(np.asarray, jp),
                          "opt": jax.tree_util.tree_map(np.asarray, jo)}}


def test_restart_on_the_mesh_is_bit_equal(ckpt_runs):
    a, b = ckpt_runs["got"]["ck_a"], ckpt_runs["got"]["ck_b"]
    assert b["steps"] == a["steps"][2:]
    for path, x, y in _leaves(a["final"], b["final"]):
        np.testing.assert_array_equal(x, y, err_msg=path)
    for path, x, y in _leaves(a["opt"], b["opt"]):
        np.testing.assert_array_equal(x, y, err_msg=path)


def test_mesh_checkpoint_restores_on_one_device(ckpt_runs):
    """The port on one device restores the (2, 2) checkpoint (its
    arrays as the restart read them, bit for bit) and its third step
    agrees with the mesh's within 1e-5 (loss, grad norm) and 1e-4
    (parameters)."""
    got = ckpt_runs["got"]
    cfg, oc, opts = ranks.setup(CASE)
    params = trainable(params_from_jax(cfg, ckpt_runs["init"],
                                       device="cpu"))
    opt = init_opt(params, oc)
    st, tree, _ = ckpt.restore(str(ckpt_runs["tmp"] / "w4" / "ck_a_ckpt"),
                               state_like(params, opt), device="cpu")
    load_state(params, opt, tree)
    assert st == 2
    mine = state_tree(params, opt)
    for path, x, y in _leaves(got["ck_b"]["restored"], mine):
        np.testing.assert_array_equal(x, y, err_msg=path)
    step = make_train_step(cfg, oc, TrainConfig(), opts=opts)
    params, opt, m = step(params, opt, ranks.batch_at(cfg, 4, 32, 2))
    check_steps([{k: float(m[k]) for k in ("loss", "grad_norm")}],
                got["ck_a"]["steps"][2:], 1e-5)
    check_params(state_tree(params, opt)["params"], got["ck_a"]["final"])


def test_mesh_checkpoint_restores_in_the_reference(ckpt_runs):
    """The reference restores the (2, 2) checkpoint into its own tree
    (bit for bit) and its third step agrees with the mesh's within 1e-4."""
    got = ckpt_runs["got"]
    jcfg, jstep = ckpt_runs["jstep"]
    oc = JOptConfig(**ranks.OPT)
    like = {"params": jax.tree_util.tree_map(jnp.asarray,
                                             ckpt_runs["init"]),
            "opt": j_init_opt(ckpt_runs["init"], oc)}
    st, tree, _ = j_ckpt.restore(
        str(ckpt_runs["tmp"] / "w4" / "ck_a_ckpt"), like)
    assert st == 2
    mine = jax.tree_util.tree_map(np.asarray, tree)
    for path, x, y in _leaves(got["ck_b"]["restored"], mine):
        np.testing.assert_array_equal(x, y, err_msg=path)
    _, _, m = jstep(tree["params"], tree["opt"], reference_batch(jcfg, 2))
    check_steps(got["ck_a"]["steps"][2:],
                [{k: float(m[k]) for k in ("loss", "grad_norm")}])


def test_one_device_checkpoint_restores_on_the_mesh(ckpt_runs):
    """The (2, 2) ranks restore a checkpoint the port wrote on one
    device: their gathered shards are the file's arrays bit for bit, and
    their third step agrees with the one-device third step within 1e-5
    (loss, grad norm) and 1e-4 (parameters)."""
    got = ckpt_runs["got"]["ck_c"]
    cfg, oc, _ = ranks.setup(CASE)
    params = trainable(params_from_jax(cfg, ckpt_runs["init"],
                                       device="cpu"))
    _, tree, _ = ckpt.restore(str(ckpt_runs["tmp"] / "one_ckpt"),
                              state_like(params, init_opt(params, oc)),
                              device="cpu")
    for path, x, y in _leaves(got["restored"], tree):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=path)
    check_steps(got["steps"], ckpt_runs["one"]["steps"], 1e-5)
    check_params(got["final"], ckpt_runs["one"]["final"])


def test_reference_checkpoint_restores_on_the_mesh(ckpt_runs):
    """The (2, 2) ranks restore a checkpoint the reference wrote after 2
    steps: their gathered shards are its arrays bit for bit, and their
    third step agrees with the reference's third step within 1e-4."""
    got = ckpt_runs["got"]["ck_d"]
    for path, x, y in _leaves(got["restored"], ckpt_runs["ref_state"]):
        np.testing.assert_array_equal(x, y, err_msg=path)
    check_steps(got["steps"], ckpt_runs["ref_third"])


def test_hybrid_checkpoint_crosses_meshes(ckpt_runs):
    """zamba2's (2, 2) checkpoint restores at (1, 1) (the shards bit for
    bit) and on one device; each takes steps 2 and 3 within 1e-5 (loss,
    grad norm) of the unbroken (2, 2) run's."""
    got = ckpt_runs["got"]
    want = got["zk_a"]["steps"][2:]
    cfg, oc, opts = ranks.setup(HYBRID)
    params = trainable(params_from_jax(cfg, ckpt_runs["zinit"],
                                       device="cpu"))
    opt = init_opt(params, oc)
    st, tree, _ = ckpt.restore(str(ckpt_runs["tmp"] / "w4" / "zk_a_ckpt"),
                               state_like(params, opt), device="cpu")
    assert st == 2
    for path, x, y in _leaves(got["zk_b"]["restored"], tree):
        np.testing.assert_array_equal(x, y.numpy(), err_msg=path)
    load_state(params, opt, tree)
    step = make_train_step(cfg, oc, TrainConfig(), opts=opts)
    ms = []
    for s in (2, 3):
        params, opt, m = step(params, opt, ranks.batch_at(cfg, 4, 32, s))
        ms.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    check_steps(got["zk_b"]["steps"], want, 1e-5)
    check_steps(ms, want, 1e-5)


@pytest.fixture(scope="module")
def factored(tmp_path_factory):
    return ranks.run_all(tmp_path_factory.mktemp("train_mesh_factored"),
                         FACTORED, dict(CASE, factored=True))


@pytest.mark.parametrize("name", FACTORED)
def test_factored_steps_equal_the_references(factored, name):
    check_steps(factored["got"][name]["steps"], factored["ref"][name]["steps"])
    check_steps(factored["got"][name]["steps"],
                factored["one_device"][ARCH]["steps"], 1e-5)


@pytest.mark.parametrize("name", FACTORED)
def test_factored_parameters_after_three_steps(factored, name):
    check_params(factored["got"][name]["final"],
                 factored["ref"][name]["final"])


@pytest.mark.parametrize("name", FACTORED)
def test_factored_statistics_reduce_over_the_cut_axis(factored, name):
    """One all-reduce per statistic of a cut dim, over the axis that cuts
    it; the step's other collectives as the dry run counts them."""
    mesh = FACTORED[name][1]
    stats = factored["got"][name]["stats"]
    axis = "fsdp" if mesh[0] > 1 else "model"
    rows = stats["factored"]
    assert rows and {r[1] for r in rows} == {axis}
    ranks.check_collectives(stats, dict(CASE, mesh=list(mesh)))
