"""Attention: GQA + RoPE + sliding window + softcap; prefill and decode
paths (the reference's ``models/attention.py`` in torch).

Prefill attention goes through the flash-attention kernel
(``kernels/flash_attention``) at every sequence length: causal self-
attention, the encoder's non-causal self-attention and the decoder's
cross-attention over the encoder's K/V (with a valid-length bound). The
reference runs its jnp twin of the same online-softmax loop there, and
the Pallas kernel is the TPU-native version of it. Decode (one query row
at ``q_offset = pos`` over the cache, or over the encoder cache for
cross-attention) stays plain torch, as the reference's einsum path: the
kernel has no query offset.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import attention_op
from repro_torch.models.params import spec

NEG_INF = -1.0e30


def attention_spec(cfg):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": spec((d, H, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, K, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((H, hd, d), ("heads", "head_dim", "embed")),
    }


def cross_attention_spec(cfg):
    return attention_spec(cfg)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x (..., S, H, hd), positions (..., S) -> rotated x."""
    hd = x.shape[-1]
    half = hd // 2
    # a Python base: a tensor built from theta would cost a host-to-device
    # copy, which waits on the device, in every layer
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., None].float() * freq                  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (...,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Core attention math (GQA grouped, no KV repeat)
# ---------------------------------------------------------------------------
def _scores_mask(s, rows, cols, *, causal: bool, window: int, softcap,
                 kv_valid):
    """window: python int, 0 = full attention."""
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    mask = cols < kv_valid
    if causal:
        mask = mask & (cols <= rows)
    if window > 0:
        mask = mask & ((rows - cols) < window)
    return torch.where(mask, s, NEG_INF)


def attn_direct(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                q_offset=0, kv_valid):
    """q (B,Sq,H,hd); k,v (B,Sk,K,hd), the first ``kv_valid`` cache rows
    valid. Quadratic plain path, f32 scores and accumulation; the output
    has q's dtype."""
    B, Sq, H, hd = q.shape
    _, Sk, K, _ = k.shape
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    rows = q_offset + torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    s = _scores_mask(s, rows, cols, causal=causal, window=window,
                     softcap=softcap, kv_valid=kv_valid)
    p = torch.softmax(s, dim=-1)
    y = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return y.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention layer (projections + rope + attention + out)
# ---------------------------------------------------------------------------
def project_qkv(p, x, positions, theta):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    return rope(q, positions, theta), rope(k, positions, theta), v


def _flash(q, k, v, **kw):
    """attention_op in the model's (B, S, heads, hd) layout (the kernel's
    is (B, heads, S, hd))."""
    return attention_op(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), **kw).transpose(1, 2)


def attention(p, x, cfg, *, window: int, positions, causal=True,
              return_kv=False, mode: str = "auto"):
    """Full-sequence attention (prefill; the encoder passes
    ``causal=False``). ``window`` is the layer's Python int (0 = full
    attention); ``mode`` the flash op's ('auto' runs the kernel on CUDA
    tensors)."""
    scale = cfg.head_dim ** -0.5
    q, k, v = project_qkv(p, x, positions, cfg.rope_theta)
    y = _flash(q, k, v, scale=scale, causal=causal, window=int(window),
               softcap=cfg.softcap_attn, mode=mode)
    out = torch.einsum("bshk,hkd->bsd", y, p["wo"])
    if return_kv:
        return out, (k, v)
    return out


def cross_attention(p, x, enc_kv, cfg, *, enc_valid=None, decode=False,
                    mode: str = "auto"):
    """Decoder cross-attention over precomputed encoder k/v (B,Se,K,hd),
    non-causal, no RoPE, no softcap; the first ``enc_valid`` encoder rows
    count (None -> all). Prefill goes through the flash op; ``decode``
    (one query row) takes the plain path, as self-attention's decode."""
    scale = cfg.head_dim ** -0.5
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k, v = enc_kv
    if decode:
        y = attn_direct(q, k, v, scale=scale, causal=False,
                        kv_valid=k.shape[1] if enc_valid is None
                        else enc_valid)
    else:
        y = _flash(q, k, v, scale=scale, causal=False, kv_valid=enc_valid,
                   mode=mode)
    return torch.einsum("bshk,hkd->bsd", y, p["wo"])


def encode_cross_kv(p, enc_out):
    k = torch.einsum("bsd,dhk->bshk", enc_out, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", enc_out, p["wv"])
    return k, v


def decode_qkv(p, x, pos: int, cfg):
    """Project the new token: x (B,1,d) -> q,k,v (B,1,·,hd) at position pos."""
    positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                           device=x.device)
    return project_qkv(p, x, positions, cfg.rope_theta)


def decode_attend(p, q, cache_k, cache_v, cfg, *, window: int, pos: int):
    """Attend the projected new-token q over an (already updated) cache."""
    scale = cfg.head_dim ** -0.5
    y = attn_direct(q, cache_k, cache_v, scale=scale, window=int(window),
                    softcap=cfg.softcap_attn, q_offset=pos, kv_valid=pos + 1)
    return torch.einsum("bshk,hkd->bsd", y, p["wo"])
