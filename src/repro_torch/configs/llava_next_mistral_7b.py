"""llava-next-mistral-7b [vlm] — mistral-7b backbone, anyres tiling stub.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]. Backbone only per the
assignment: the vision frontend is a STUB — input_specs() provides
precomputed anyres patch embeddings (2880 tokens = 5x576 tiles) that are
scattered into the prompt prefix. Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1000000.0,
    frontend="vision",
    frontend_tokens=2880,
    subquadratic=False,
)
