"""dbrx-132b [moe] — 16 experts top-4, fine-grained MoE.

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4
[hf:databricks/dbrx-base; unverified]. Full attention -> long_500k skipped
per the assignment (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b",
    family="moe",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    num_experts=16,
    num_experts_per_tok=4,
    rope_theta=500000.0,
    subquadratic=False,
)
