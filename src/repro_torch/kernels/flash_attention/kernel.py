"""Chunked online-softmax attention (flash attention) — the hand-written
CUDA kernels' wrappers: the forward, and the backward that the training
path takes through ``ops.FlashAttentionFn``.

Beyond-paper kernel for the LM serving side (the prefill hot spot): one
thread block per (q block, head, batch) carries the online softmax over
the kv blocks in registers, and query-head groups read their shared kv
head in place (``csrc/flash_attention.cu`` has the design and what
bounds it). The public layout is the reference kernel's: q (B,H,S,dh),
k/v (B,Hkv,Skv,dh).

The backward (``csrc/flash_attention_bwd.cu``) has no Pallas
counterpart: the reference differentiates its jnp twin through the
block-recomputing ``_fa_bwd_impl`` (``src/repro/models/attention.py:253``),
which it ports. It recomputes the probabilities from the forward's row
log-sum-exp, so the forward writes that when asked (``return_lse``). Its
first kernel writes P and dS once into a band scratch that its second
kernel sums from; :func:`band_plan` sizes that scratch.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref,
                                                     attention_ref)

KERNEL = Kernel(name="flash_attention", source="flash_attention.cu",
                entry="flash_attention_launch",
                replaces="src/repro/kernels/flash_attention/kernel.py:83")
BWD_KERNEL = Kernel(name="flash_attention_bwd",
                    source="flash_attention_bwd.cu",
                    entry="flash_attention_bwd_launch",
                    replaces="src/repro/models/attention.py:253")

# S and Skv must be multiples of these (the op pads). The forward's q
# blocks are 64 rows, the rows of the last one beyond S masked, its kv
# blocks 64 rows with the rows beyond Skv zeroed; the backward's q tiles
# are 32 rows, its kv tiles 64 (zeroed beyond Skv) in its first kernel
# and 32 in its second.
BLOCK_Q = 32
BLOCK_K = 32
# the backward's band scratch: P and dS (f32) in tiles of BAND_Q q rows x
# BAND_K kv columns, the live kv tiles of each q tile side by side; above
# BAND_BUDGET bytes of scratch the kernels run over slices of the
# (batch, kv head) grid in turn
BAND_Q = 32
BAND_K = 64
BAND_BUDGET = 1 << 30
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _check_kind(name: str, q) -> None:
    """Raise unless q's dtype and head dim are ones the kernels take."""
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {DTYPES}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in "
                         f"{HEAD_DIMS}")


def _check(name: str, q, k, v) -> None:
    """Raise unless q, k, v fit the kernels (on CUDA tensors)."""
    B, H, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    _check_kind(name, q)
    check_cuda_operands(name, {
        "q": (q, q.dtype, (B, H, S, dh)),
        "k": (k, q.dtype, (B, Hkv, Skv, dh)),
        "v": (v, q.dtype, (B, Hkv, Skv, dh)),
    })
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} is not 16-byte aligned")


def _shapes(name: str, q, k, s_orig: int) -> int:
    """Check the block multiples and GQA; return s_orig (0 -> Skv)."""
    H, S = q.shape[1], q.shape[2]
    Hkv, Skv = k.shape[1], k.shape[2]
    if H % Hkv:
        raise ValueError(f"{name}: H={H} is not a multiple of Hkv={Hkv}")
    if S % BLOCK_Q or Skv % BLOCK_K:
        raise ValueError(f"{name}: S={S} and Skv={Skv} must be multiples "
                         f"of {BLOCK_Q} and {BLOCK_K}")
    return min(s_orig or Skv, Skv)


def live_cols(q0: int, s_orig: int, *, causal: bool,
              window: int) -> tuple[int, int]:
    """The live kv columns [lo, hi] of the ``BAND_Q`` query rows from
    ``q0`` (empty when lo > hi): every column in it counts for at least
    one of those rows. The backward kernels compute the same interval."""
    lo = max(0, q0 - window + 1) if window > 0 else 0
    hi = (min(s_orig, q0 + BAND_Q) if causal else s_orig) - 1
    return lo, hi


def band_layout(S: int, *, causal: bool, window: int,
                s_orig: int) -> list[tuple[int, int]]:
    """Per q tile of ``BAND_Q`` rows: (its first live kv tile of
    ``BAND_K`` columns, its number of live kv tiles), the kv tiles that
    meet :func:`live_cols`."""
    out = []
    for i in range(S // BAND_Q):
        lo, hi = live_cols(i * BAND_Q, s_orig, causal=causal, window=window)
        out.append((lo // BAND_K, hi // BAND_K - lo // BAND_K + 1)
                   if lo <= hi else (0, 0))
    return out


def band_plan(B: int, H: int, Hkv: int, S: int, *, causal: bool,
              window: int, s_orig: int) -> tuple[int, int, int]:
    """(band width in kv tiles, (batch, kv head) pairs per pass, floats of
    each of the P and dS scratches): the scratch of a pass holds its pairs'
    G = H / Hkv heads x S / BAND_Q q tiles x width tiles, and a pass takes
    as many pairs as fit in ``BAND_BUDGET`` bytes of both, at least one."""
    width = max(n for _, n in band_layout(S, causal=causal, window=window,
                                          s_orig=s_orig))
    per_bh = (H // Hkv) * (S // BAND_Q) * width * BAND_Q * BAND_K
    per_pass = max(1, min(B * Hkv, BAND_BUDGET // (2 * 4 * per_bh)))
    return width, per_pass, per_pass * per_bh


@functools.lru_cache(maxsize=256)
def live_pairs(S: int, s_orig: int, *, causal: bool, window: int) -> int:
    """Unmasked (row, col) pairs of one (batch, head): row r sees the
    columns below s_orig, up to r when causal, from r - window + 1 when
    windowed."""
    total = 0
    for r in range(S):
        hi = min(r, s_orig - 1) if causal else s_orig - 1
        lo = max(0, r - window + 1) if window > 0 else 0
        total += max(0, hi - lo + 1)
    return total


def cost(q_shape, kv_numel: int, itemsize: int, s_orig: int, *,
         causal: bool, window: int, lse: bool = False,
         backward: bool = False) -> tuple:
    """(operations, bytes) of one forward or backward launch: 2 dh per
    product and unmasked pair and head, two products forward (s, o) and
    five backward (s, dP, dq, dk, dv); each operand read and each output
    written once (forward: q, k, v, out [, lse]; backward: q, k, v, out,
    dout, lse, dq, dk, dv). ``kv_numel``: elements of k (= of v)."""
    B, H, S, dh = q_shape
    pairs = live_pairs(S, s_orig, causal=causal, window=window) * B * H
    qn, rows = B * H * S * dh, B * H * S
    if backward:
        return (10.0 * dh * pairs,
                float(itemsize * (4 * qn + 4 * kv_numel) + 4 * rows))
    return (4.0 * dh * pairs,
            float(itemsize * (2 * qn + 2 * kv_numel) + 4 * rows * lse))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    softcap: float = 0.0, s_orig: int = 0,
                    return_lse: bool = False):
    """q (B,H,S,dh); k,v (B,Hkv,Skv,dh); H % Hkv == 0. Returns (B,H,S,dh)
    in q's dtype; with ``return_lse`` also the rows' log-sum-exp (B,H,S)
    f32 (m + log l of the online softmax, the backward's input).

    S and Skv must be multiples of ``BLOCK_Q`` / ``BLOCK_K`` (the op pads).
    ``s_orig``: true kv length before padding (0 -> Skv). ``window``: 0
    for full attention, else sliding-window size. ``softcap``: 0
    disables. CPU tensors take the plain version; CUDA tensors (f32 or
    bf16, dh in ``HEAD_DIMS``) launch the kernel or raise; "meta"
    tensors (a plan) get meta outputs and report the launch's cost
    (``Kernel.shape_only``). Without ``return_lse`` the kernel writes no
    lse (the serving launch).
    """
    B, H, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    s_orig = _shapes("flash_attention", q, k, s_orig)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              s_orig=s_orig)
    if q.is_meta:
        _check_kind("flash_attention", q)
        out = torch.empty_like(q)
        lse = torch.empty((B, H, S), dtype=torch.float32, device="meta")
        KERNEL.shape_only(cost=lambda: cost(
            q.shape, k.numel(), q.element_size(), s_orig, causal=causal,
            window=window, lse=return_lse))
        return (out, lse) if return_lse else out
    if not q.is_cuda:
        if return_lse:
            return attention_fwd_ref(q, k, v, **kw)
        return attention_ref(q, k, v, **kw)
    _check("flash_attention", q, k, v)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel():
        KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      out.data_ptr(), lse.data_ptr() if return_lse else None,
                      B, H, Hkv, S, Skv, dh, s_orig, float(scale),
                      int(causal), int(window), float(softcap),
                      int(q.dtype == torch.bfloat16),
                      cost=lambda: cost(q.shape, k.numel(), q.element_size(),
                                        s_orig, causal=causal, window=window,
                                        lse=return_lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale: float,
                        causal: bool = True, window: int = 0,
                        softcap: float = 0.0, s_orig: int = 0):
    """The backward of :func:`flash_attention` from its output and lse:
    (dq (B,H,S,dh), dk, dv (B,Hkv,Skv,dh)) in q's dtype, each written
    once by one thread block (no atomics: the same inputs give the same
    bits on every run). dout must be zero on rows that do not count
    (the op's padding rows). CPU tensors take ``attention_bwd_ref``; CUDA
    tensors launch the kernels or raise: one launch of the C entry, which
    runs both kernels once per pass of :func:`band_plan` over the band
    scratch allocated here. "meta" tensors (a plan) get meta outputs and
    report the launch's cost."""
    B, H, S, dh = q.shape
    _, Hkv, Skv, _ = k.shape
    s_orig = _shapes("flash_attention_bwd", q, k, s_orig)
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap,
              s_orig=s_orig)
    if q.is_meta:
        _check_kind("flash_attention_bwd", q)
        BWD_KERNEL.shape_only(cost=lambda: cost(
            q.shape, k.numel(), q.element_size(), s_orig, causal=causal,
            window=window, backward=True))
        return tuple(torch.empty_like(x) for x in (q, k, v))
    if not q.is_cuda:
        return attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    _check("flash_attention_bwd", q, k, v)
    check_cuda_operands("flash_attention_bwd", {
        "out": (out, q.dtype, (B, H, S, dh)),
        "dout": (dout, q.dtype, (B, H, S, dh)),
        "lse": (lse, torch.float32, (B, H, S)),
    })
    for arg, x in (("out", out), ("dout", dout)):
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {arg} is not 16-byte "
                             f"aligned")
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if q.numel() and k.numel():
        width, per_pass, numel = band_plan(B, H, Hkv, S, causal=causal,
                                           window=window, s_orig=s_orig)
        p_band, ds_band = (torch.empty(numel, dtype=torch.float32,
                                       device=q.device) for _ in range(2))
        BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                          out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
                          dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                          p_band.data_ptr(), ds_band.data_ptr(), B, H, Hkv,
                          S, Skv, dh, s_orig, float(scale), int(causal),
                          int(window), float(softcap),
                          int(q.dtype == torch.bfloat16), width, per_pass,
                          cost=lambda: cost(q.shape, k.numel(),
                                            q.element_size(), s_orig,
                                            causal=causal, window=window,
                                            backward=True))
    return dq, dk, dv
