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
kernel has no query offset. Under grad (the training path) the flash op
goes through ``FlashAttentionFn``: the forward kernel with its row
log-sum-exp and the hand-written backward kernel.

``attn_chunked`` and the chunked ``flash_attention`` with its recomputing
backward (``_fa_fwd_impl``, ``_fa_bwd_impl``) are plain-torch twins of
the reference's jnp versions, held against ``attn_direct`` by the tests;
no path on the card calls them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import attention_op
from repro_torch.models.layers import dot
from repro_torch.models.params import spec
from repro_torch.utils import round_up

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
    """window: python int, 0 = full attention; rows (from ``q_offset``)
    and ``kv_valid`` Python ints or device tensors (decode)."""
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


def _pad_seq(x, n: int):
    """Zero-pad (B, S, ...) to S + n rows."""
    return F.pad(x, (0, 0) * (x.dim() - 2) + (0, n))


def _blocks(q, k, v, qc: int, kc: int, extra=()):
    """Pad the sequences to chunk multiples: (qp, kp, vp, *extra padded
    as q)."""
    Sq, Sk = q.shape[1], k.shape[1]
    pq, pk = round_up(Sq, qc) - Sq, round_up(Sk, kc) - Sk
    return (_pad_seq(q, pq), _pad_seq(k, pk), _pad_seq(v, pk),
            *(_pad_seq(x, pq) for x in extra))


def _chunk_scores(q_f, k_blk, qi, kj, qc, kc, *, scale, causal, window,
                  softcap, q_offset, kv_lim):
    """Masked scores (B,K,G,qc,kc) of q chunk qi against kv chunk kj."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q_f, k_blk.float()) * scale
    rows = q_offset + qi * qc + torch.arange(qc, device=q_f.device)[:, None]
    cols = kj * kc + torch.arange(kc, device=q_f.device)[None, :]
    return _scores_mask(s, rows, cols, causal=causal, window=window,
                        softcap=softcap, kv_valid=kv_lim)


def _online_softmax(q, k, v, *, scale, causal, window, softcap, q_offset,
                    kv_valid, q_chunk, kv_chunk):
    """The online-softmax loops shared by attn_chunked and the flash
    forward: (y (B,Sq,H,hd), lse (B,K,G,Sqp))."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    qp, kp, vp = _blocks(q, k, v, qc, kc)
    kv_lim = min(Sk if kv_valid is None else int(kv_valid), Sk)
    kw = dict(scale=scale, causal=causal, window=int(window),
              softcap=softcap, q_offset=q_offset, kv_lim=kv_lim)
    ys, lses = [], []
    for qi in range(qp.shape[1] // qc):
        q_f = qp[:, qi * qc:(qi + 1) * qc].reshape(B, qc, K, G, hd).float()
        m = q_f.new_full((B, K, G, qc, 1), NEG_INF)
        l = q_f.new_zeros((B, K, G, qc, 1))
        acc = q_f.new_zeros((B, K, G, qc, hd))
        for kj in range(kp.shape[1] // kc):
            s = _chunk_scores(q_f, kp[:, kj * kc:(kj + 1) * kc], qi, kj, qc,
                              kc, **kw)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p,
                              vp[:, kj * kc:(kj + 1) * kc].float())
            acc = acc * alpha + pv
            m = m_new
        lses.append(torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                                0.0)[..., 0])
        y = (acc / l.clamp_min(1e-30)).permute(0, 3, 1, 2, 4)
        ys.append(y.reshape(B, qc, H, hd).to(q.dtype))
    return torch.cat(ys, 1)[:, :Sq], torch.cat(lses, -1)


def attn_chunked(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                 q_offset=0, kv_valid=None, q_chunk=512, kv_chunk=1024):
    """Online-softmax loop over kv chunks inside a loop over q chunks
    (the reference's ``attn_chunked``): one (q_chunk x kv_chunk) score
    block per head group at a time, f32 accumulators. Matches
    attn_direct to float tolerance."""
    return _online_softmax(q, k, v, scale=scale, causal=causal,
                           window=window, softcap=softcap, q_offset=q_offset,
                           kv_valid=kv_valid, q_chunk=q_chunk,
                           kv_chunk=kv_chunk)[0]


def _fa_bwd_impl(q, k, v, y, lse, dy, *, scale, causal, window, softcap,
                 q_offset, kv_valid, q_chunk, kv_chunk):
    """Block-recomputing backward (the reference's ``_fa_bwd_impl``):
    per kv chunk, per q chunk, P from lse, dS = P (dP - D) (x (1 - t^2)
    under a softcap) x scale. Returns (dq, dk, dv)."""
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qc, kc = min(q_chunk, Sq), min(kv_chunk, Sk)
    qp, kp, vp, yp, dyp = _blocks(q, k, v, qc, kc, extra=(y, dy))
    Sqp = qp.shape[1]
    kv_lim = min(Sk if kv_valid is None else int(kv_valid), Sk)
    # D = rowsum(dy * y) per head -> (B,K,G,Sqp)
    D = (dyp.float() * yp.float()).sum(-1)
    D = D.reshape(B, Sqp, K, G).permute(0, 2, 3, 1)
    dq = q.new_zeros((B, Sqp, K, G, hd), dtype=torch.float32)
    dks, dvs = [], []
    for kj in range(kp.shape[1] // kc):
        k_f = kp[:, kj * kc:(kj + 1) * kc].float()
        v_f = vp[:, kj * kc:(kj + 1) * kc].float()
        dkj = k_f.new_zeros((B, kc, K, hd))
        dvj = k_f.new_zeros((B, kc, K, hd))
        for qi in range(Sqp // qc):
            rs = slice(qi * qc, (qi + 1) * qc)
            q_f = qp[:, rs].reshape(B, qc, K, G, hd).float()
            dy_f = dyp[:, rs].reshape(B, qc, K, G, hd).float()
            s_raw = torch.einsum("bqkgd,bskd->bkgqs", q_f, k_f) * scale
            t = None
            if softcap > 0.0:
                t = torch.tanh(s_raw / softcap)
                s_raw = softcap * t
            rows = q_offset + qi * qc + torch.arange(qc, device=q.device)
            cols = kj * kc + torch.arange(kc, device=q.device)
            s_m = _scores_mask(s_raw, rows[:, None], cols[None, :],
                               causal=causal, window=int(window),
                               softcap=0.0, kv_valid=kv_lim)
            p = torch.exp(s_m - lse[..., rs, None])            # (b,k,g,q,s)
            dp = torch.einsum("bqkgd,bskd->bkgqs", dy_f, v_f)
            ds = p * (dp - D[..., rs, None])
            if t is not None:
                ds = ds * (1.0 - t * t)
            ds = ds * scale
            dq[:, rs] += torch.einsum("bkgqs,bskd->bqkgd", ds, k_f)
            dkj = dkj + torch.einsum("bkgqs,bqkgd->bskd", ds, q_f)
            dvj = dvj + torch.einsum("bkgqs,bqkgd->bskd", p, dy_f)
        dks.append(dkj)
        dvs.append(dvj)
    dq = dq.reshape(B, Sqp, H, hd)[:, :Sq].to(q.dtype)
    dk = torch.cat(dks, 1)[:, :Sk].to(k.dtype)
    dv = torch.cat(dvs, 1)[:, :Sk].to(v.dtype)
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """The reference's custom-VJP ``flash_attention`` in torch: the
    forward saves only (q, k, v, y, lse); the backward recomputes the
    score blocks (O(S d) residuals)."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        y, lse = _online_softmax(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, y, lse)
        ctx.kw = kw
        return y

    @staticmethod
    def backward(ctx, dy):
        q, k, v, y, lse = ctx.saved_tensors
        return (*_fa_bwd_impl(q, k, v, y, lse, dy, **ctx.kw), None)


def flash_attention(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                    q_offset=0, kv_valid=None, q_chunk=512, kv_chunk=1024):
    """Chunked attention with recompute-in-backward (the reference's jnp
    ``flash_attention``: a drop-in for attn_chunked, the same forward,
    O(S d) residuals). q (B,Sq,H,hd), k/v (B,Sk,K,hd)."""
    return _Flash.apply(q, k, v, dict(
        scale=float(scale), causal=bool(causal), window=int(window),
        softcap=float(softcap), q_offset=int(q_offset), kv_valid=kv_valid,
        q_chunk=int(q_chunk), kv_chunk=int(kv_chunk)))


# ---------------------------------------------------------------------------
# Full attention layer (projections + rope + attention + out)
# ---------------------------------------------------------------------------
def project_qkv(p, x, positions, theta):
    q = dot(x, p["wq"], "bsd,dhk->bshk")
    k = dot(x, p["wk"], "bsd,dhk->bshk")
    v = dot(x, p["wv"], "bsd,dhk->bshk")
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
    out = dot(y, p["wo"], "bshk,hkd->bsd")
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
    q = dot(x, p["wq"], "bsd,dhk->bshk")
    k, v = enc_kv
    if decode:
        y = attn_direct(q, k, v, scale=scale, causal=False,
                        kv_valid=k.shape[1] if enc_valid is None
                        else enc_valid)
    else:
        y = _flash(q, k, v, scale=scale, causal=False, kv_valid=enc_valid,
                   mode=mode)
    return dot(y, p["wo"], "bshk,hkd->bsd")


def encode_cross_kv(p, enc_out):
    k = dot(enc_out, p["wk"], "bsd,dhk->bshk")
    v = dot(enc_out, p["wv"], "bsd,dhk->bshk")
    return k, v


def decode_qkv(p, x, pos, cfg):
    """Project the new token: x (B,1,d) -> q,k,v (B,1,·,hd) at position
    pos (the cache's 0-d int32 tensor)."""
    positions = pos.view(1, 1).expand(x.shape[0], 1)
    return project_qkv(p, x, positions, cfg.rope_theta)


def decode_attend(p, q, cache_k, cache_v, cfg, *, window: int, pos):
    """Attend the projected new-token q over an (already updated) cache;
    ``pos`` is the cache's 0-d position tensor, ``window`` the layer's
    Python int."""
    scale = cfg.head_dim ** -0.5
    y = attn_direct(q, cache_k, cache_v, scale=scale, window=int(window),
                    softcap=cfg.softcap_attn, q_offset=pos, kv_valid=pos + 1)
    return dot(y, p["wo"], "bshk,hkd->bsd")
