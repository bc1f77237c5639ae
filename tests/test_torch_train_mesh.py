"""The sharded training step (``make_train_step(mesh=)``) on ``gloo``
ranks against the reference's sharded step: reduced gemma3-1b at
(data, model) = (2, 2), (4, 1) and (1, 4) on a world of 4 and (2, 1) on
a world of 2; batch 4 x 32, loss chunk 32, remat full, 3 steps,
weights from the reference's ``PRNGKey(0)``.

Gates: each step's loss and grad norm within 1e-4 relative of the
reference's sharded step on the same mesh (``PARITY_RTOL``,
tests/test_torch_train.py) and within 1e-5 of the port's one-device
step; the parameters after 3 steps within 1e-4 (atol and rtol) of the
reference's; the collectives the rank counted, through the dry run's
ring formulas, equal ``launch/dryrun.py``'s for the same cell, kind for
kind; a grad-accum 2 mesh step within the reference's own grad-accum
tolerances (loss 2e-4, grad norm 2e-3) of the grad-accum 1 step.
"""
import pytest

import torch_train_mesh_ranks as ranks
from torch_train_mesh_ranks import check_params, check_steps, close

_one_torch_thread = ranks.one_torch_thread()
ARCH = "gemma3-1b"
ONE_DEVICE_RTOL = 1e-5
MESHES = {"g22": (2, 2), "g41": (4, 1), "g14": (1, 4), "g21": (2, 1)}
CASE = dict(arch=ARCH, steps=3, batch=4, seq=32, stats_step=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_all(
        tmp_path_factory.mktemp("train_mesh"),
        {n: (ARCH, m) for n, m in MESHES.items()}, CASE,
        extra=(dict(name="g21_ga2", arch=ARCH, mesh=[2, 1], grad_accum=2),
               dict(name="g22_dots", arch=ARCH, mesh=[2, 2],
                    remat="dots")))


@pytest.mark.parametrize("name", MESHES)
def test_steps_equal_the_references_sharded_step(runs, name):
    check_steps(runs["got"][name]["steps"], runs["ref"][name]["steps"])


@pytest.mark.parametrize("name", MESHES)
def test_steps_equal_the_ports_one_device_step(runs, name):
    check_steps(runs["got"][name]["steps"], runs["one_device"][ARCH]["steps"],
                ONE_DEVICE_RTOL)


@pytest.mark.parametrize("name", MESHES)
def test_parameters_after_three_steps(runs, name):
    check_params(runs["got"][name]["final"], runs["ref"][name]["final"])


@pytest.mark.parametrize("name", MESHES)
def test_collectives_equal_the_dry_runs(runs, name):
    """Per kind, bytes on the wire and calls of step 1 (the scalar
    reductions of the loss, the norm and the guard are counted apart:
    one world all-reduce each for the norm and the guard, one over the
    data axes for the loss's sums)."""
    mesh = MESHES[name]
    scalars = ranks.check_collectives(runs["got"][name]["stats"],
                                      dict(CASE, mesh=list(mesh)))
    assert scalars.pop(("all-reduce", "world")) == 2
    if mesh[0] > 1:
        assert scalars.pop(("all-reduce", "fsdp")) == 1
    assert not scalars


def test_grad_accum_two_on_a_mesh(runs):
    """(2, 1) at grad-accum 2: each micro-batch is this data shard's rows
    of the reference's micro-batch; the reference's grad-accum
    tolerances against the grad-accum 1 step (loss 2e-4 absolute, grad
    norm 2e-3 relative, as tests/test_torch_train.py)."""
    got = runs["got"]["g21_ga2"]["steps"]
    for g, r in zip(got, runs["ref"]["g21"]["steps"]):
        assert abs(g["loss"] - r["loss"]) < 2e-4
        close(g["grad_norm"], r["grad_norm"], 2e-3, "grad_norm")
    ranks.check_collectives(runs["got"]["g21_ga2"]["stats"],
                            dict(CASE, mesh=[2, 1], grad_accum=2))


def test_dots_equals_full_on_a_mesh(runs):
    """remat "dots" at (2, 2): the same losses, grad norms and parameters
    as remat full bit for bit (the kept products are the values the
    recompute would make), and the collectives of the dry run's dots
    cell (the FSDP gathers inside each block run again in its
    recompute, as under full)."""
    ranks.check_dots(runs, "g22_dots", "g22",
                     dict(CASE, mesh=[2, 2], remat="dots"))
