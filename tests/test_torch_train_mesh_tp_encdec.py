"""Tensor parallelism for the encoder-decoder family against the
reference's sharded step: reduced seamless-m4t-medium (its audio-stub
batch as the encoder's input) at (data, model) = (1, 2) and (2, 2);
batch 4 x 32, loss chunk 32, remat full, 3 steps, the reference's
``PRNGKey(0)`` weights. The gates of
tests/test_torch_train_mesh_tp_ssd.py: steps against the reference's
sharded step (f32), steps, first-step gradients and parameters against
the port's one-device step (f64), and the collectives against
``launch/dryrun.py``'s, kind by kind: the encoder's attention and MLP cut as the decoder's, the
cross-attention's queries and output (Megatron's f and g), the encoder's
output through f once (every rank's cross-attention reads it for its
own heads), and the vocab's sums.
"""
import torch_train_mesh_ranks as ranks

ENTRIES = {"seamless_m2": ("seamless-m4t-medium", (1, 2)),
           "seamless_d2m2": ("seamless-m4t-medium", (2, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1, grads_step=0)

globals().update(ranks.gate_tests(ENTRIES, CASE, f64=True))
