"""Architecture registry + reduced (smoke-test) variants (the port's own
copy of the reference registry and its ten configurations)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.zamba2_1p2b import CONFIG as _zamba2
from repro_torch.configs.gemma3_1b import CONFIG as _gemma3
from repro_torch.configs.yi_34b import CONFIG as _yi
from repro_torch.configs.llama3_405b import CONFIG as _llama3
from repro_torch.configs.gemma2_27b import CONFIG as _gemma2
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless
from repro_torch.configs.mamba2_780m import CONFIG as _mamba2
from repro_torch.configs.llava_next_mistral_7b import CONFIG as _llava

_REGISTRY = {
    "zamba2-1.2b": _zamba2,
    "gemma3-1b": _gemma3,
    "yi-34b": _yi,
    "llama3-405b": _llama3,
    "gemma2-27b": _gemma2,
    "mixtral-8x7b": _mixtral,
    "dbrx-132b": _dbrx,
    "seamless-m4t-medium": _seamless,
    "mamba2-780m": _mamba2,
    "llava-next-mistral-7b": _llava,
}


def list_archs():
    return sorted(_REGISTRY)


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    return _REGISTRY[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Tiny same-family variant for CPU smoke tests (one fwd/train step)."""
    few_layers = min(cfg.num_layers, 7 if cfg.family == "hybrid" else 4)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        num_layers=few_layers,
        d_model=64,
        num_heads=min(cfg.num_heads, 4) if cfg.num_heads else 0,
        num_kv_heads=(min(cfg.num_kv_heads, 2)
                      if 0 < cfg.num_kv_heads < cfg.num_heads else
                      (min(cfg.num_heads, 4) if cfg.num_heads else 0)),
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 16) if cfg.window else 0,
        num_experts=min(cfg.num_experts, 4) if cfg.num_experts else 0,
        num_experts_per_tok=(min(cfg.num_experts_per_tok, 2)
                             if cfg.num_experts_per_tok else 0),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=16 if cfg.ssm_state else 0,
        hybrid_attn_every=3 if cfg.hybrid_attn_every else 0,
        enc_layers=min(cfg.enc_layers, 2),
        frontend_tokens=min(cfg.frontend_tokens, 8),
    )
