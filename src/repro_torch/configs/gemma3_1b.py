"""gemma3-1b [dense] — 5:1 local:global attention, 128k-class context.

26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]. Sliding window 512 on local layers;
every 6th layer is global. Runs long_500k: 21-22 local layers are O(window)
per token and the global layers are O(S) per decoded token (linear, not
quadratic), so the 500k decode is tractable (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    window=512,
    window_pattern="gemma3",
    rope_theta=1000000.0,
    tie_embeddings=True,
    subquadratic=True,
)
