"""gemma2-27b [dense] — alternating local/global attention, logit softcap.

46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000
[arXiv:2408.00118; hf]. Even layers sliding-window 4096, odd layers global;
attention logits softcapped at 50, final logits at 30. Runs long_500k
(global layers are linear per decoded token; DESIGN.md §6).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2-27b",
    family="dense",
    num_layers=46,
    d_model=4608,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    window=4096,
    window_pattern="alternate",
    softcap_attn=50.0,
    softcap_final=30.0,
    tie_embeddings=True,
    act="gelu",
    subquadratic=True,
)
