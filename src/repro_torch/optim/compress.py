"""Gradient compression for the slow cross-pod hop (the reference's
``optim/compress.py`` in torch).

Error-feedback int8 quantization: each pod quantizes (grad + carried
error) to int8 with one f32 scale per tensor, exchanges the int8 payload
over the pod group (all_gather: 1 byte per element on the wire against 4
for an f32 all-reduce), sums locally, and carries the quantization
residual into the next step. Error feedback makes the *accumulated*
update unbiased: the residual is never dropped, only delayed.

The reference runs ``cross_pod_grad_sync`` inside ``shard_map`` over a
"pod" mesh axis; here the axis is a ``torch.distributed`` process group.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class EFState(NamedTuple):
    err: torch.Tensor          # carried quantization residual, same shape


def ef_init(x: torch.Tensor) -> EFState:
    return EFState(err=torch.zeros_like(x, dtype=torch.float32))


def quantize_int8(x: torch.Tensor):
    """x f32 -> (q int8, scale f32 0-d). scale covers the max magnitude."""
    amax = torch.max(torch.abs(x))
    scale = torch.clamp(amax, min=1e-30) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress(x: torch.Tensor, st: EFState):
    """Error-feedback compress: returns (q, scale, new_state)."""
    y = x.to(torch.float32) + st.err
    q, scale = quantize_int8(y)
    return q, scale, EFState(err=y - dequantize_int8(q, scale))


def cross_pod_grad_sync(grad: torch.Tensor, st: EFState, *, group=None):
    """Average ``grad`` over the ranks of ``group`` (the pods; None -> the
    default group) with int8 error-feedback compression. Every rank of
    the group calls it. Wire payload: an int8 all_gather plus one f32
    scale per rank, in place of an f32 all-reduce."""
    n = dist.get_world_size(group)
    q, scale, st = ef_compress(grad, st)
    qs = [torch.empty_like(q) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    scales = [torch.empty_like(scale) for _ in range(n)]
    dist.all_gather(scales, scale.contiguous(), group=group)
    summed = torch.tensordot(torch.stack(scales),
                             torch.stack(qs).to(torch.float32),
                             dims=([0], [0]))
    return (summed / n).to(grad.dtype), st
