"""Chunked online-softmax attention (flash attention) — the hand-written
CUDA kernel's wrapper.

Beyond-paper kernel for the LM serving side (the prefill hot spot): one
thread block per (q block, head, batch) carries the online softmax over
the kv blocks in registers, and query-head groups read their shared kv
head in place (``csrc/flash_attention.cu`` has the design and what
bounds it). The public layout is the reference kernel's: q (B,H,S,dh),
k/v (B,Hkv,Skv,dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.flash_attention.ref import attention_ref

KERNEL = Kernel(name="flash_attention", source="flash_attention.cu",
                entry="flash_attention_launch",
                replaces="src/repro/kernels/flash_attention/kernel.py:83")

# S and Skv must be multiples of these (the op pads). The kernel's q
# blocks are 64 rows, the rows of the last one beyond S masked; its kv
# blocks are 32 rows.
BLOCK_Q = 32
BLOCK_K = 32
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, s_orig: int = 0) -> torch.Tensor:
    """q (B,H,S,dh); k,v (B,Hkv,Skv,dh); H % Hkv == 0. Returns (B,H,S,dh)
    in q's dtype.

    S and Skv must be multiples of ``BLOCK_Q`` / ``BLOCK_K`` (the op pads).
    ``s_orig``: true kv length before padding (0 -> Skv). ``window``: 0
    for full attention, else sliding-window size. ``softcap``: 0
    disables. CPU tensors take the plain version; CUDA tensors (f32 or
    bf16, dh in ``HEAD_DIMS``) launch the kernel or raise.
    """
    B, H, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    if H % Hkv:
        raise ValueError(f"flash_attention: H={H} is not a multiple of "
                         f"Hkv={Hkv}")
    if S % BLOCK_Q or Skv % BLOCK_K:
        raise ValueError(f"flash_attention: S={S} and Skv={Skv} must be "
                         f"multiples of {BLOCK_Q} and {BLOCK_K}")
    s_orig = s_orig or Skv
    if not q.is_cuda:
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap, s_orig=s_orig)
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in {DTYPES}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {dh} not in "
                         f"{HEAD_DIMS}")
    check_cuda_operands("flash_attention", {
        "q": (q, q.dtype, (B, H, S, dh)),
        "k": (k, q.dtype, (B, Hkv, Skv, dh)),
        "v": (v, q.dtype, (B, Hkv, Skv, dh)),
    })
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, H, Hkv, S, Skv, dh, min(s_orig, Skv), float(scale),
                  int(causal), int(window), float(softcap),
                  int(q.dtype == torch.bfloat16))
    return out
