"""The sharded training step with the expert-parallel MoE against the
reference's sharded step: reduced mixtral-8x7b at (data, model) = (2,
2), (4, 1), (1, 4) on a world of 4 and (2, 1) on a world of 2 (batch 4
x 32, loss chunk 32, remat full, 3 steps, the reference's ``PRNGKey(0)``
weights). The reference's selection rule makes two meanings: where the
model axis splits d_ff (2, 2 and 1, 4) the shard-map layer, with each
data shard dispatching its own rows; elsewhere the one-device layer's
over the whole batch (global first-come-first-served ranks and
capacity). Gates as tests/test_torch_train_mesh.py, and ``lb_loss`` and
``drop_frac`` within 1e-6 of the reference's.
"""
import pytest

import torch_train_mesh_ranks as ranks
from torch_train_mesh_ranks import check_params, check_steps

_one_torch_thread = ranks.one_torch_thread()
ARCH = "mixtral-8x7b"
MESHES = {"m22": (2, 2), "m41": (4, 1), "m14": (1, 4), "m21": (2, 1)}
CASE = dict(arch=ARCH, steps=3, batch=4, seq=32, stats_step=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ranks.run_all(tmp_path_factory.mktemp("train_mesh_moe"),
                         {n: (ARCH, m) for n, m in MESHES.items()}, CASE)


@pytest.mark.parametrize("name", MESHES)
def test_steps_equal_the_references_sharded_step(runs, name):
    """loss and grad norm within 1e-4, lb_loss and drop_frac within 1e-6."""
    got, ref = runs["got"][name]["steps"], runs["ref"][name]["steps"]
    assert all({"lb_loss", "drop_frac"} <= set(r) for r in ref)
    check_steps(got, ref)


@pytest.mark.parametrize("name", MESHES)
def test_parameters_after_three_steps(runs, name):
    check_params(runs["got"][name]["final"], runs["ref"][name]["final"])


@pytest.mark.parametrize("name,meaning", [("m22", "shard_map"),
                                          ("m14", "global"),
                                          ("m41", "global"),
                                          ("m21", "global")])
def test_meanings_of_the_runs(runs, name, meaning):
    """At (2, 2) each data shard dispatches its own rows, so the step
    differs from the one-device step (the reference's 5.919719 against
    5.907875 at step 0); at (1, 4) (one data shard) and wherever the
    model axis is 1 the step is the one-device step's, within 1e-5."""
    got = runs["got"][name]["steps"]
    alone = runs["one_device"][ARCH]["steps"]
    if meaning == "global":
        check_steps(got, alone, 1e-5)
    else:
        assert abs(got[0]["loss"] - alone[0]["loss"]) > 1e-3
        assert abs(runs["ref"][name]["steps"][0]["loss"] - 5.919719) < 1e-5


@pytest.mark.parametrize("name", MESHES)
def test_collectives_equal_the_dry_runs(runs, name):
    """Per kind as the dry run counts them; apart: the norm and the
    guard (world), the loss's sums and, at (2, 2), the shard-map layer's
    lb_loss and drop_frac mean (one each over the data axes); the global
    layer's per-layer (E,) count gathers and statistic sums over the
    data axes, in each run of a block function that reaches them."""
    mesh = MESHES[name]
    scalars = ranks.check_collectives(runs["got"][name]["stats"],
                                      dict(CASE, mesh=list(mesh)))
    assert scalars.pop(("all-reduce", "world")) == 2
    if mesh == (2, 2):
        assert scalars.pop(("all-reduce", "fsdp")) == 2
    elif mesh[0] > 1:
        L = 4
        # a block's stats in its forward and its recompute, the kept
        # count's sum in the forward only (the recompute stops before
        # it), and the loss's sums
        assert scalars.pop(("all-gather", "fsdp")) == 2 * L
        assert scalars.pop(("all-reduce", "fsdp")) == 2 * L + L + 1
    assert not scalars
