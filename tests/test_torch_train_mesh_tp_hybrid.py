"""Tensor parallelism for the hybrid family against the reference's
sharded step: reduced zamba2-1.2b at (data, model) = (1, 2) and (2, 2),
where its SSD layers' d_inner and its shared block's heads and d_ff
split; the setup and gates of tests/test_torch_train_mesh_tp_ssd.py
(kept apart from it so that each file stays short inside the suite).
The shared block is gathered once outside every remat and applied once
per group; the group's recompute stops before its MLP's output
all-reduce, as the dry run counts.

This case is why the one-device gates run in float64: in f32 the mesh's
first gradient of ``blocks.4.ssm.wdt[49, 6]`` rounds to the other sign
than one device's, and the steps and parameters after Adam's first
update differ by 1.02e-5 and 3.65e-4; in f64 the two agree to 1.40e-14
and 4.77e-13 (``torch_train_mesh_ranks.F64_RTOL``). A rank-only remat
"dots" case at (1, 2) is held to the remat full one bit for bit.
"""
import torch_train_mesh_ranks as ranks

ENTRIES = {"zamba2_m2": ("zamba2-1.2b", (1, 2)),
           "zamba2_d2m2": ("zamba2-1.2b", (2, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1, grads_step=0)

globals().update(ranks.gate_tests(
    ENTRIES, CASE, f64=True,
    extra=(dict(name="zamba2_m2_dots", arch="zamba2-1.2b", mesh=[1, 2],
                remat="dots"),)))


def test_dots_equals_full_on_a_mesh(runs):
    """remat "dots" at (1, 2): bit for bit the remat full step (losses,
    grad norms, parameters), with the dry run's collectives for the dots
    cell: the hybrid's group recompute still stops before the shared
    block's MLP output all-reduce."""
    ranks.check_dots(runs, "zamba2_m2_dots", "zamba2_m2",
                     dict(CASE, arch="zamba2-1.2b", mesh=[1, 2],
                          remat="dots"))
