"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. The shared attention+MLP block (one weight set) is
applied every 6th Mamba2 layer; the paper's concat-re-embedding input to
the shared block is simplified to the running hidden state (DESIGN.md §6).
Shared attention uses a 4096 sliding window so the 500k decode stays
sub-quadratic (hardware adaptation note, DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    hybrid_attn_every=6,
    window=4096,
    window_pattern="all_local",
    tie_embeddings=True,
    subquadratic=True,
)
