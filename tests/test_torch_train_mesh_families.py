"""The sharded training step for the SSD families against the
reference's sharded step: reduced zamba2-1.2b (hybrid) and mamba2-780m
(ssm) at (data, model) = (2, 1), FSDP alone; batch 4 x 32, loss chunk
32, remat full, 3 steps, the reference's ``PRNGKey(0)`` weights. The
f32 gates of ``torch_train_mesh_ranks.gate_tests``. Their tensor
parallelism (a model axis of 2) is tests/test_torch_train_mesh_tp_ssd.py's
and tests/test_torch_train_mesh_tp_hybrid.py's
(tests/test_torch_train_mesh_frontends.py has the encdec and vlm
families).

The parameters of zamba2 after 3 steps differ from the reference's by
up to 1.216e-4 at one element (``blocks.ssm.wo``) in the port's
one-device step too: Adam amplifies a near-zero gradient's rounding.
The parameter gate takes the larger of 1e-4 (atol and rtol) and the
one-device port's own distance plus 1e-5.
"""
import torch_train_mesh_ranks as ranks

ENTRIES = {"zamba2": ("zamba2-1.2b", (2, 1)),
           "mamba2": ("mamba2-780m", (2, 1))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1)

globals().update(ranks.gate_tests(ENTRIES, CASE))
