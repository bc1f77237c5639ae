"""Plain PyTorch flash-attention oracle (GQA, causal, window, softcap) —
the kernel's plain version, with the reference ``ref.py``'s contract —
and the plain versions of the forward with its row log-sum-exp and of
the backward (the math of the reference's block-recomputing
``_fa_bwd_impl``, ``src/repro/models/attention.py:253``)."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def _mask(S: int, Skv: int, device, *, causal: bool, window: int,
          s_orig: int) -> torch.Tensor:
    """(S, Skv) bool: the (row, col) pairs that count."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(Skv, device=device)[None, :]
    mask = cols < s_orig
    if causal:
        mask = mask & (cols <= rows)
    if window > 0:
        mask = mask & ((rows - cols) < window)
    return mask


def _scores(q, k, *, scale, causal, window, softcap, s_orig):
    """Masked f32 scores (B,H,S,Skv) over k repeated to H heads, and the
    softcap's tanh (None without a softcap)."""
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    t = None
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = softcap * t
    mask = _mask(q.shape[2], k.shape[2], q.device, causal=causal,
                 window=window, s_orig=s_orig or k.shape[2])
    return torch.where(mask, s, NEG_INF), t


def _attend(q, k, v, **kw):
    """(out in q's dtype, the masked f32 scores)."""
    group = q.shape[1] // k.shape[1]
    s, _ = _scores(q, k, **kw)
    p = torch.softmax(s, dim=-1)
    v = v.repeat_interleave(group, dim=1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype), s


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: int = 0, softcap: float = 0.0,
                  s_orig: int = 0) -> torch.Tensor:
    """Same contract as :func:`flash_attention`: q (B,H,S,dh), k/v
    (B,Hkv,Skv,dh), H % Hkv == 0; ``s_orig`` the true kv length before
    padding (0 -> Skv), ``window`` 0 for full attention, ``softcap`` 0
    disables. f32 scores and softmax; the output has q's dtype."""
    return _attend(q, k, v, scale=scale, causal=causal, window=window,
                   softcap=softcap, s_orig=s_orig)[0]


def attention_fwd_ref(q, k, v, *, scale: float, causal: bool = True,
                      window: int = 0, softcap: float = 0.0,
                      s_orig: int = 0):
    """:func:`attention_ref` and its rows' log-sum-exp: (out, lse (B,H,S)
    f32), lse = m + log(l) over the masked scores (the reference's
    ``_fa_fwd_impl`` convention; every row here has l >= 1)."""
    out, s = _attend(q, k, v, scale=scale, causal=causal, window=window,
                     softcap=softcap, s_orig=s_orig)
    return out, torch.logsumexp(s, dim=-1)


def attention_bwd_ref(q, k, v, out, lse, dout, *, scale: float,
                      causal: bool = True, window: int = 0,
                      softcap: float = 0.0, s_orig: int = 0):
    """The backward of :func:`attention_fwd_ref` from its saved lse, as
    ``_fa_bwd_impl`` computes it: D = rowsum(dout . out); P recomputed
    as exp(s - lse); dS = P (dP - D), times (1 - t^2) under a softcap,
    times the scale. Returns (dq, dk, dv) in the inputs' dtypes, the kv
    gradients summed over each kv head's query heads."""
    B, H, S, dh = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = H // Hkv
    s, t = _scores(q, k, scale=scale, causal=causal, window=window,
                   softcap=softcap, s_orig=s_orig)
    p = torch.exp(s - lse[..., None])
    dof = dout.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    D = (dof * out.float()).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - D[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.float())
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dk = dk.reshape(B, Hkv, group, Skv, dh).sum(2)
    dv = dv.reshape(B, Hkv, group, Skv, dh).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
