"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2
[arXiv:2401.04088; hf]. SWA window 4096 on every layer -> long_500k runs
(decode touches only the 4096-token window per layer; DESIGN.md §6).
The MoE dispatch shares the capacity-bounded routing discipline with the
paper's Allocator (core/dispatch.py).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_experts=8,
    num_experts_per_tok=2,
    window=4096,
    window_pattern="all_local",
    rope_theta=1000000.0,
    subquadratic=True,
)
