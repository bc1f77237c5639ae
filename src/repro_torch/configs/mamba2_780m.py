"""mamba2-780m [ssm] — SSD (state-space duality), attention-free.

48L d_model=1536 (attn-free) d_ff=0 vocab=50280, ssm_state=128
[arXiv:2405.21060; unverified]. O(1) decode state -> runs long_500k
natively. The graph-traversal retrieval technique applies to the
retrieval stage unchanged (DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    tie_embeddings=True,
    subquadratic=True,
)
