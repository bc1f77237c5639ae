"""The sharded training step for the SSD families against the
reference's sharded step: reduced zamba2-1.2b (hybrid) and mamba2-780m
(ssm) at (data, model) = (2, 1), FSDP alone; batch 4 x 32, loss chunk
32, remat full, 3 steps, the reference's ``PRNGKey(0)`` weights. The
gates of tests/test_torch_train_mesh.py. Tensor parallelism for the
ssm, hybrid and encdec families is ROADMAP item 16c: at a model axis of
2 they raise ``NotImplementedError``
(tests/test_torch_train_mesh_frontends.py has the encdec and vlm
families).

The parameters of zamba2 after 3 steps differ from the reference's by
up to 1.216e-4 at one element (``blocks.ssm.wo``) in the port's
one-device step too: Adam amplifies a near-zero gradient's rounding.
The parameter gate takes the larger of 1e-4 (atol and rtol) and the
one-device port's own distance plus 1e-5.
"""
import pytest

import torch_train_mesh_ranks as ranks
from torch_train_mesh_ranks import check_params, check_steps

ENTRIES = {"zamba2": ("zamba2-1.2b", (2, 1)),
           "mamba2": ("mamba2-780m", (2, 1))}
REFUSED = {"mamba2_m2": ("mamba2-780m", (1, 2)),
           "zamba2_m2": ("zamba2-1.2b", (1, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    extra = [dict(name=n, arch=a, mesh=list(m), expect="NotImplementedError")
             for n, (a, m) in REFUSED.items()]
    return ranks.run_all(tmp_path_factory.mktemp("train_mesh_families"),
                         ENTRIES, CASE, extra=extra)


@pytest.mark.parametrize("name", ENTRIES)
def test_steps_equal_the_references_sharded_step(runs, name):
    check_steps(runs["got"][name]["steps"], runs["ref"][name]["steps"])


@pytest.mark.parametrize("name", ENTRIES)
def test_steps_equal_the_ports_one_device_step(runs, name):
    arch = ENTRIES[name][0]
    check_steps(runs["got"][name]["steps"],
                runs["one_device"][arch]["steps"], 1e-5)


@pytest.mark.parametrize("name", ENTRIES)
def test_parameters_after_three_steps(runs, name):
    arch = ENTRIES[name][0]
    check_params(runs["got"][name]["final"], runs["ref"][name]["final"],
                 runs["one_device"][arch]["final"])


@pytest.mark.parametrize("name", ENTRIES)
def test_collectives_equal_the_dry_runs(runs, name):
    arch, mesh = ENTRIES[name]
    scalars = ranks.check_collectives(
        runs["got"][name]["stats"], dict(CASE, arch=arch, mesh=list(mesh)))
    assert scalars == {("all-reduce", "world"): 2, ("all-reduce", "fsdp"): 1}


@pytest.mark.parametrize("name", REFUSED)
def test_model_axis_waits_for_item_16c(runs, name):
    got = runs["got"][name]
    assert got["raised"] == "NotImplementedError"
    assert "16c" in got["message"]
