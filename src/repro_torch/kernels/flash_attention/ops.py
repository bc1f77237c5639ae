"""Public attention op: mode dispatch + shape padding, and the autograd
function that carries the training path through the two kernels."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.flash_attention.kernel import (BLOCK_K, BLOCK_Q,
                                                        flash_attention,
                                                        flash_attention_bwd)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.utils import round_up


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a hand-written backward — the twin of the
    reference's custom-VJP ``flash_attention``
    (``src/repro/models/attention.py:362``). The forward saves q, k, v,
    its output and its rows' log-sum-exp; the backward recomputes the
    probabilities from them. On CUDA tensors both directions launch the
    kernels (``flash_attention(return_lse=True)``, ``flash_attention_bwd``);
    on CPU tensors both take the plain versions (``attention_fwd_ref``,
    ``attention_bwd_ref``). Block-multiple shapes, as the kernels take."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool, window: int,
                softcap: float, s_orig: int):
        kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
                  s_orig=s_orig)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def attention_op(q, k, v, *, scale: float, causal: bool = True,
                 window: int = 0, softcap: float = 0.0,
                 kv_valid: int | None = None,
                 mode: str = "auto") -> torch.Tensor:
    """Pads S/Skv to block multiples, runs the kernel or the plain
    version, slices back. ``kv_valid``: the first kv rows that count
    (cross-attention over a padded encoder cache; None -> all Skv); both
    versions take ``min(kv_valid, Skv)`` as their ``s_orig``. mode:
    'auto' | 'cuda' | 'ref'.

    When grad mode is on and q, k or v requires grad (the training
    path), 'auto' and 'cuda' go through :class:`FlashAttentionFn` (the
    kernels on the card, their plain versions on the CPU) on the padded
    tensors, and autograd carries the padding and the slice; otherwise
    the forward runs alone and writes no lse. 'ref' is the plain version
    ``attention_ref``, which autograd differentiates as it is."""
    S, Skv = q.shape[2], k.shape[2]
    s_orig = Skv if kv_valid is None else min(int(kv_valid), Skv)
    if s_orig < 1:
        raise ValueError(f"attention_op: kv_valid={kv_valid} leaves no "
                         f"key to attend")
    resolved = resolve_kernel_mode(mode, q)
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if mode == "ref" or (resolved == "ref" and not grad):
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap, s_orig=s_orig)
    Sp, Skvp = round_up(S, BLOCK_Q), round_up(Skv, BLOCK_K)
    qp = F.pad(q, (0, 0, 0, Sp - S)).contiguous()
    kp = F.pad(k, (0, 0, 0, Skvp - Skv)).contiguous()
    vp = F.pad(v, (0, 0, 0, Skvp - Skv)).contiguous()
    if grad:
        out = FlashAttentionFn.apply(qp, kp, vp, float(scale), bool(causal),
                                     int(window), float(softcap), s_orig)
    else:
        out = flash_attention(qp, kp, vp, scale=scale, causal=causal,
                              window=window, softcap=softcap, s_orig=s_orig)
    return out[:, :, :S, :]
