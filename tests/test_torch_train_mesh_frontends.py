"""The sharded training step for the families with a frontend input
against the reference's sharded step: reduced seamless-m4t-medium
(encdec, its audio-stub batch as the encoder's input) at (data, model)
= (2, 1), FSDP alone, and llava-next-mistral-7b (vlm, its vision-stub
batch over the prompt's first positions) at (2, 2); batch 4 x 32, loss
chunk 32, remat full, 3 steps, the reference's ``PRNGKey(0)`` weights.
The gates of tests/test_torch_train_mesh_families.py.
"""
import numpy as np
import pytest

import torch_train_mesh_ranks as ranks
from torch_train_mesh_ranks import check_params, check_steps

ENTRIES = {"seamless": ("seamless-m4t-medium", (2, 1)),
           "llava": ("llava-next-mistral-7b", (2, 2))}
REFUSED = {"seamless_m2": ("seamless-m4t-medium", (1, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    extra = [dict(name=n, arch=a, mesh=list(m), expect="NotImplementedError")
             for n, (a, m) in REFUSED.items()]
    return ranks.run_all(tmp_path_factory.mktemp("train_mesh_frontends"),
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


def test_cli_runs_the_mesh_on_gloo(tmp_path):
    """``python -m repro_torch.launch.train --mesh 2,2 --device cpu`` on
    four processes (RANK and WORLD_SIZE, a file rendezvous): rank 0
    writes the metrics of every step, finite and not skipped; the other
    ranks print nothing."""
    import json
    import os
    import subprocess
    import sys
    procs = []
    for r in range(4):
        env = dict(os.environ, PYTHONPATH=str(ranks.REPO / "src"),
                   OMP_NUM_THREADS="1", RANK=str(r), WORLD_SIZE="4")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "llava-next-mistral-7b", "--reduced", "--mesh", "2,2",
             "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
             "32", "--loss-chunk", "32", "--log-every", "1",
             "--init-method", f"file://{tmp_path / 'rdv'}",
             "--metrics-out", str(tmp_path / "metrics.json")],
            cwd=ranks.REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=ranks.TIMEOUT_S)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, outs
    hist = json.loads((tmp_path / "metrics.json").read_text())
    assert [h["step"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and not h["skipped"] for h in hist)
    assert "step     0" in outs[0]
    assert all("step " not in o for o in outs[1:])
