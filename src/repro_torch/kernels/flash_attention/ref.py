"""Plain PyTorch flash-attention oracle (GQA, causal, window, softcap) —
the kernel's plain version, with the reference ``ref.py``'s contract."""
from __future__ import annotations

import torch

NEG_INF = -1.0e30


def attention_ref(q, k, v, *, scale: float, causal: bool = True,
                  window: int = 0, softcap: float = 0.0,
                  s_orig: int = 0) -> torch.Tensor:
    """Same contract as :func:`flash_attention`: q (B,H,S,dh), k/v
    (B,Hkv,Skv,dh), H % Hkv == 0; ``s_orig`` the true kv length before
    padding (0 -> Skv), ``window`` 0 for full attention, ``softcap`` 0
    disables. f32 scores and softmax; the output has q's dtype."""
    B, H, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    group = H // Hkv
    s_orig = s_orig or Skv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap > 0.0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(S, device=q.device)[:, None]
    cols = torch.arange(Skv, device=q.device)[None, :]
    mask = cols < s_orig
    if causal:
        mask = mask & (cols <= rows)
    if window > 0:
        mask = mask & ((rows - cols) < window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
