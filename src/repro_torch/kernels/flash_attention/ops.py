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
                 mode: str = "auto") -> torch.Tensor:
    """Pads S/Skv to block multiples, runs the kernel or the plain
    version, slices back. mode: 'auto' | 'cuda' | 'ref'."""
    if resolve_kernel_mode(mode, q) == "ref":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    S, Skv = q.shape[2], k.shape[2]
    Sp, Skvp = round_up(S, BLOCK_Q), round_up(Skv, BLOCK_K)
    qp = F.pad(q, (0, 0, 0, Sp - S)).contiguous()
    kp = F.pad(k, (0, 0, 0, Skvp - Skv)).contiguous()
    vp = F.pad(v, (0, 0, 0, Skvp - Skv)).contiguous()
    out = flash_attention(qp, kp, vp, scale=scale, causal=causal,
                          window=window, softcap=softcap, s_orig=Skv)
    return out[:, :, :S, :]
