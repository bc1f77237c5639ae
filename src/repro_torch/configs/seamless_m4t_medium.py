"""seamless-m4t-medium [audio] — encoder-decoder, multimodal backbone.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].
Backbone only per the assignment: 12 encoder + 12 decoder layers at
d=1024; the speech frontend is a STUB (input_specs() provides precomputed
fbank-frame embeddings). The text+unit decoders are collapsed into one
decoder (DESIGN.md §6). Full attention, encoder-decoder: long_500k skipped.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,           # decoder depth
    enc_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    frontend="audio",
    act="gelu",
    subquadratic=False,
)
