"""Public attention op: mode dispatch + shape padding."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.flash_attention.kernel import (BLOCK_K, BLOCK_Q,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils import round_up


def attention_op(q, k, v, *, scale: float, causal: bool = True,
                 window: int = 0, softcap: float = 0.0,
                 kv_valid: int | None = None,
                 mode: str = "auto") -> torch.Tensor:
    """Pads S/Skv to block multiples, runs the kernel or the plain
    version, slices back. ``kv_valid``: the first kv rows that count
    (cross-attention over a padded encoder cache; None -> all Skv); both
    versions take ``min(kv_valid, Skv)`` as their ``s_orig``. mode:
    'auto' | 'cuda' | 'ref'."""
    S, Skv = q.shape[2], k.shape[2]
    s_orig = Skv if kv_valid is None else min(int(kv_valid), Skv)
    if s_orig < 1:
        raise ValueError(f"attention_op: kv_valid={kv_valid} leaves no "
                         f"key to attend")
    if resolve_kernel_mode(mode, q) == "ref":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap, s_orig=s_orig)
    Sp, Skvp = round_up(S, BLOCK_Q), round_up(Skv, BLOCK_K)
    qp = F.pad(q, (0, 0, 0, Sp - S)).contiguous()
    kp = F.pad(k, (0, 0, 0, Skvp - Skv)).contiguous()
    vp = F.pad(v, (0, 0, 0, Skvp - Skv)).contiguous()
    out = flash_attention(qp, kp, vp, scale=scale, causal=causal,
                          window=window, softcap=softcap, s_orig=s_orig)
    return out[:, :, :S, :]
