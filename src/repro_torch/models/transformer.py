"""Model assembly for the dense and vlm families (the reference's
``models/transformer.py`` in torch).

  dense   llama3/yi/gemma2/gemma3 (GQA, RoPE, sliding-window patterns,
          logit softcaps)
  vlm     the llava backbone (vision-stub embeddings over the prompt
          prefix)

The other families raise ``NotImplementedError`` naming the ROADMAP.md
item that ports them. Three entry points, as in the reference:

  forward_hidden   full-sequence (scoring)               -> final hidden
  prefill          full-sequence + cache population      -> (last logits, cache)
  decode_step      one token against the cache           -> (logits, cache)

The parameters are one ``nn.Module`` tree (``models/params.py``): the
layers are an ``nn.ModuleList`` of blocks run in a Python loop — PyTorch
runs eagerly, so the reference's layer scan and remat have no
counterpart here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models.layers import (embed, embed_spec, mlp, mlp_spec,
                                       rmsnorm, rmsnorm_spec, unembed)
from repro_torch.models.params import materialize
from repro_torch.utils import resolve_device

FAMILIES = ("dense", "vlm")
_NOT_PORTED = {
    "moe": "ROADMAP.md queue A item 14b (models/moe.py)",
    "ssm": "ROADMAP.md queue A item 14c (models/ssm.py)",
    "hybrid": "ROADMAP.md queue A item 14c (models/ssm.py)",
    "encdec": "ROADMAP.md queue A item 14d (cross_attention)",
}


def check_family(cfg: ArchConfig) -> None:
    if cfg.family in FAMILIES:
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family} family is not ported yet; see "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(cfg.family)


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """Static per-run model options."""

    act_dtype: torch.dtype = torch.float32  # residual-stream compute dtype
    attn_mode: str = "auto"      # prefill flash op: auto | cuda | ref


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def attn_mlp_block_spec(cfg: ArchConfig):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "attn": A.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def model_spec(cfg: ArchConfig):
    """The reference's spec tree with the layer axis unstacked: "blocks"
    is a list of per-layer block specs (the same per-layer init scales)."""
    check_family(cfg)
    d, L = cfg.d_model, cfg.num_layers
    return {"tok": embed_spec(cfg.vocab_padded(), d, cfg.tie_embeddings),
            "fln": rmsnorm_spec(d),
            "blocks": [attn_mlp_block_spec(cfg) for _ in range(L)]}


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.float32) -> nn.Module:
    """Random-init parameters, drawn from ``gen`` on its device."""
    return materialize(model_spec(cfg), gen, dtype=dtype)


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg, tokens, opts, frontend_embeds):
    """Token embeddings; ``frontend_embeds`` (B,F,d) — patch embeddings
    or retrieved soft prompts — overwrite the first F prompt positions."""
    x = embed(params["tok"], tokens).to(opts.act_dtype)
    if frontend_embeds is not None:
        x = x.clone()
        F = frontend_embeds.shape[1]
        x[:, :F] = frontend_embeds.to(x.dtype)
    return x


def _positions(tokens):
    B, Sq = tokens.shape
    return torch.arange(Sq, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, Sq)


def _block(p, x, cfg, win, positions, opts, return_kv=False):
    h = A.attention(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps), cfg,
                    window=win, positions=positions, return_kv=return_kv,
                    mode=opts.attn_mode)
    if return_kv:
        h, kv = h
    x = x + h
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), act=cfg.act)
    return (x, kv) if return_kv else x


# ---------------------------------------------------------------------------
# forward_hidden / logits
# ---------------------------------------------------------------------------
def forward_hidden(params, cfg: ArchConfig, tokens, *,
                   opts: ModelOpts = ModelOpts(), frontend_embeds=None):
    """tokens (B,S) -> (hidden (B,S,d) final-normed, aux dict)."""
    check_family(cfg)
    x = _embed_inputs(params, cfg, tokens, opts, frontend_embeds)
    positions = _positions(tokens)
    for p, win in zip(params["blocks"], cfg.layer_windows()):
        x = _block(p, x, cfg, win, positions, opts)
    return rmsnorm(params["fln"], x, cfg.norm_eps), {}


def logits_fn(params, cfg: ArchConfig, tokens, *,
              opts: ModelOpts = ModelOpts(), frontend_embeds=None):
    """Convenience full-logits path (tests / tiny configs only)."""
    h, aux = forward_hidden(params, cfg, tokens, opts=opts,
                            frontend_embeds=frontend_embeds)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[..., :cfg.vocab_size], aux


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def cache_spec(cfg: ArchConfig, batch: int, cache_len: int):
    """Shapes of the decode cache: per-layer (B, cache_len, K, hd) k and
    v, and the next position."""
    check_family(cfg)
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"pos": (), "k": [shape] * cfg.num_layers,
            "v": [shape] * cfg.num_layers}


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               dtype=torch.bfloat16, device="cuda"):
    """Zeroed cache on ``device``. The k/v caches are LISTS of per-layer
    tensors that prefill and decode_step update in place (the reference
    keeps a list of per-layer leaves for the same reason: one buffer per
    layer is written where it lies, never copied)."""
    device = resolve_device(device)
    cs = cache_spec(cfg, batch, cache_len)
    return {"pos": 0,
            "k": [torch.zeros(s, dtype=dtype, device=device)
                  for s in cs["k"]],
            "v": [torch.zeros(s, dtype=dtype, device=device)
                  for s in cs["v"]]}


# ---------------------------------------------------------------------------
# Prefill — full-sequence forward that also populates the cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, cache, *,
            opts: ModelOpts = ModelOpts(), frontend_embeds=None):
    """tokens (B,S) with S <= cache_len. Returns (last logits (B,V),
    cache); the cache's per-layer tensors are written in place.

    All prompts in the batch share length S (positions are absolute)."""
    check_family(cfg)
    B, Sq = tokens.shape
    x = _embed_inputs(params, cfg, tokens, opts, frontend_embeds)
    positions = _positions(tokens)
    cache = dict(cache)
    for i, (p, win) in enumerate(zip(params["blocks"], cfg.layer_windows())):
        x, (k, v) = _block(p, x, cfg, win, positions, opts, return_kv=True)
        cache["k"][i][:, :Sq] = k.to(cache["k"][i].dtype)
        cache["v"][i][:, :Sq] = v.to(cache["v"][i].dtype)
    cache["pos"] = Sq
    h = rmsnorm(params["fln"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[:, 0, :cfg.vocab_size], cache


# ---------------------------------------------------------------------------
# Decode — one token against the cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                opts: ModelOpts = ModelOpts()):
    """tokens (B,1) -> (logits (B,V), cache). pos = cache['pos']; each
    layer writes only its new (B,1,K,hd) slot, in place, and attends over
    the same tensor."""
    check_family(cfg)
    pos = cache["pos"]
    x = embed(params["tok"], tokens).to(opts.act_dtype)
    cache = dict(cache)
    for i, (p, win) in enumerate(zip(params["blocks"], cfg.layer_windows())):
        q, k, v = A.decode_qkv(p["attn"], rmsnorm(p["ln1"], x, cfg.norm_eps),
                               pos, cfg)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, pos:pos + 1] = k.to(ck.dtype)
        cv[:, pos:pos + 1] = v.to(cv.dtype)
        x = x + A.decode_attend(p["attn"], q, ck, cv, cfg, window=win,
                                pos=pos)
        x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps),
                    act=cfg.act)
    cache["pos"] = pos + 1
    h = rmsnorm(params["fln"], x, cfg.norm_eps)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[:, 0, :cfg.vocab_size], cache
