"""The sharded training step for the families with a frontend input
against the reference's sharded step: reduced seamless-m4t-medium
(encdec, its audio-stub batch as the encoder's input) at (data, model)
= (2, 1), FSDP alone, and llava-next-mistral-7b (vlm, its vision-stub
batch over the prompt's first positions) at (2, 2); batch 4 x 32, loss
chunk 32, remat full, 3 steps, the reference's ``PRNGKey(0)`` weights.
The f32 gates of ``torch_train_mesh_ranks.gate_tests``. The encdec
family's tensor parallelism (a model axis of 2) is
tests/test_torch_train_mesh_tp_encdec.py's.
"""
import numpy as np

import torch_train_mesh_ranks as ranks

ENTRIES = {"seamless": ("seamless-m4t-medium", (2, 1)),
           "llava": ("llava-next-mistral-7b", (2, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1)

globals().update(ranks.gate_tests(ENTRIES, CASE))


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
