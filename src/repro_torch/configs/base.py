"""Architecture + shape schema for the assigned model pool.

The port's own copy of the reference package's ``configs/base.py``: the
same fields and derived quantities, so both packages size every model
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int               # 0 = attention-free
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention pattern
    window: int = 0              # sliding-window size; 0 = full attention
    window_pattern: str = "none" # none | gemma3 (5 local : 1 global)
                                 #      | alternate (gemma2 local/global)
                                 #      | all_local (mixtral SWA)
    softcap_attn: float = 0.0
    softcap_final: float = 0.0
    rope_theta: float = 10000.0

    # MoE
    num_experts: int = 0
    num_experts_per_tok: int = 0

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    hybrid_attn_every: int = 0   # zamba2: shared attn+MLP block every k layers

    # encoder-decoder (seamless): num_layers = decoder depth
    enc_layers: int = 0

    # modality frontend stub
    frontend: str = "none"       # none | vision | audio
    frontend_tokens: int = 0     # embedding positions supplied by the stub

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"

    # long_500k applicability (sub-quadratic decode path exists)
    subquadratic: bool = False

    # -- derived ---------------------------------------------------------
    def vocab_padded(self, multiple: int = 256) -> int:
        """Embedding-table rows: vocab padded so it shards on any mesh
        axis up to ``multiple`` (odd vocab sizes like 256206/50280 would
        otherwise replicate the (B,S,V) loss logits per chip)."""
        return -(-self.vocab_size // multiple) * multiple

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_state else 0

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer sliding-window size (0 = full attention)."""
        L = self.num_layers
        if self.window_pattern == "gemma3":   # 5 local : 1 global
            return tuple(0 if (i + 1) % 6 == 0 else self.window
                         for i in range(L))
        if self.window_pattern == "alternate":  # gemma2: even local, odd glob
            return tuple(self.window if i % 2 == 0 else 0 for i in range(L))
        if self.window_pattern == "all_local":
            return tuple(self.window for i in range(L))
        return tuple(0 for _ in range(L))

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        total = V * d                       # embedding
        if not self.tie_embeddings:
            total += V * d                  # head
        if self.family == "ssm" or self.family == "hybrid":
            di, ds, nh = self.d_inner, self.ssm_state, self.ssm_heads
            conv_ch = di + 2 * ds
            per = (d * (2 * di + 2 * ds + nh)      # in_proj
                   + conv_ch * self.ssm_conv       # conv
                   + 2 * nh + nh                   # A_log, D, dt_bias
                   + di                            # gated norm
                   + di * d + d)                   # out_proj + norm
            total += per * L
            if self.family == "hybrid":
                H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim
                shared = (d * (H + 2 * K) * hd + H * hd * d
                          + 2 * d * f + f * d + 2 * d)
                total += shared             # one shared block
            return total
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim
        attn = d * (H + 2 * K) * hd + H * hd * d + 2 * d
        if self.is_moe:
            ffn = self.num_experts * 3 * d * f + d * self.num_experts
        else:
            ffn = 3 * d * f
        dec = L * (attn + ffn)
        enc = self.enc_layers * (attn + 3 * d * f)
        cross = self.enc_layers and L * (d * (H + 2 * K) * hd + H * hd * d + d)
        return total + dec + enc + (cross or 0)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
