"""Paged SiN distance (§IV-C4) — the hand-written CUDA kernel's wrapper.

The paper's LUN-level accelerator reads one NAND page into the page
buffer and MACs a batch of queries against every vector in it. Here a
thread block walks a group of consecutive tiles and reads a page once
per run of tiles that share it, serving each (QB, d) query tile against
the (P, d) page ``page_ids[t]`` of the paged store (``csrc/
paged_distance.cu`` has the design and what bounds it).

Distances use  q.q - 2 q.v + v.v ; qq and vnorm are precomputed.
Queries and store are f32 or bf16, in any pair: each pair is one
instantiation of the kernel, with a launch count of its own, and bf16
operands are upcast to f32 as they are staged (the f32 result on the
upcast operands, bit for bit).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.distance.ref import paged_distances_ref

_F32, _BF16 = torch.float32, torch.bfloat16
# one handle per (queries, db) dtype pair: the kernel template's
# instantiations, each with its own C entry point and launch count
KERNELS = {
    (q, d): Kernel(name=f"paged_distance{sfx}", source="paged_distance.cu",
                   entry=f"paged_distance{sfx}_launch",
                   replaces="src/repro/kernels/distance/kernel.py:40")
    for (q, d), sfx in (((_F32, _F32), ""), ((_BF16, _F32), "_bf16q"),
                        ((_F32, _BF16), "_bf16db"),
                        ((_BF16, _BF16), "_bf16q_bf16db"))}
KERNEL = KERNELS[(_F32, _F32)]

SMEM_MAX = 227 * 1024        # dynamic shared memory one block may ask for
SMEM_SM = 228 * 1024         # shared memory of one SM
MAX_BLOCKS_PER_SM = 3        # the kernel's __launch_bounds__
MQ = 64                      # the kernel's query rows per compute chunk


def _smem(p: int, dc: int) -> int:
    """Shared memory of one block: the page (rows padded to an even
    count) and MQ query rows, at the kernel's row pitch for d-chunk dc."""
    return (2 * ((p + 1) // 2) + MQ) * 4 * ((dc // 4) | 1) * 4


@functools.lru_cache(maxsize=None)
def _dchunk(p: int, d: int) -> int:
    """The whole d (rounded up to 4) when page and queries fit shared
    memory, else the widest multiple of 4 that fits."""
    dc = max(4, -(-d // 4) * 4)
    while dc >= 4 and _smem(p, dc) > SMEM_MAX:
        dc -= 4
    if dc < 4:
        raise ValueError(f"paged_distance: a page of {p} rows plus {MQ} "
                         f"query rows does not fit shared memory")
    return dc


@functools.lru_cache(maxsize=None)
def _resident_blocks(device: int, p: int, dc: int) -> int:
    """Blocks of the kernel that one wave of the card holds at once."""
    per_sm = min(MAX_BLOCKS_PER_SM, SMEM_SM // (_smem(p, dc) + 1024))
    return per_sm * torch.cuda.get_device_properties(device) \
        .multi_processor_count


def cost(T: int, QB: int, P: int, d: int, NP: int, pages: int | None = None,
         q_itemsize: int = 4, db_itemsize: int = 4) -> tuple:
    """(operations, bytes) of one launch: the products (2 d per query
    and row) and the norms' three (q.q - 2 q.v + v.v), and each operand
    read and the output written once, a page once however many tiles
    read it. ``pages``: the distinct pages the tiles read (what this
    run's data needs); from the shapes alone at most min(T, NP)."""
    pages = min(T, NP) if pages is None else pages
    ops = 2.0 * T * QB * P * d + 3.0 * T * QB * P
    nbytes = (T * 4 + T * QB * d * q_itemsize + T * QB * 4
              + pages * P * (d * db_itemsize + 4) + T * QB * P * 4)
    return ops, float(nbytes)


def paged_distances(page_ids: torch.Tensor, queries: torch.Tensor,
                    qq: torch.Tensor, db: torch.Tensor,
                    vnorm: torch.Tensor) -> torch.Tensor:
    """Per-tile query->page squared-L2 distances.

    page_ids : (T,)        i32       page read per tile
    queries  : (T, QB, d)  f32/bf16  query tiles (dispatcher-grouped)
    qq       : (T, QB)     f32       per-query self dot
    db       : (NP, P, d)  f32/bf16  paged vector store
    vnorm    : (NP, P)     f32       per-vector self dot
    returns  : (T, QB, P)  f32

    CPU tensors take the plain version; CUDA tensors launch the kernel
    instantiation of the (queries, db) dtypes, or raise; "meta" tensors
    (a plan) get a meta output and report the launch's cost.
    """
    if not (queries.is_cuda or queries.is_meta):
        return paged_distances_ref(page_ids, queries, qq, db, vnorm)
    T, QB, d = queries.shape
    NP, P = db.shape[0], db.shape[1]
    kernel = KERNELS.get((queries.dtype, db.dtype))
    if kernel is None:
        raise TypeError(f"paged_distance: queries and db must be float32 "
                        f"or bfloat16, got {queries.dtype} and {db.dtype}")
    if queries.is_meta:
        kernel.shape_only(cost=lambda: cost(
            T, QB, P, d, NP, q_itemsize=queries.element_size(),
            db_itemsize=db.element_size()))
        return torch.empty((T, QB, P), dtype=_F32, device="meta")
    check_cuda_operands("paged_distance", {
        "page_ids": (page_ids, torch.int32, (T,)),
        "queries": (queries, queries.dtype, (T, QB, d)),
        "qq": (qq, _F32, (T, QB)),
        "db": (db, db.dtype, (NP, P, d)),
        "vnorm": (vnorm, _F32, (NP, P)),
    })
    out = torch.empty((T, QB, P), dtype=_F32, device=queries.device)
    if T == 0 or QB == 0 or P == 0:
        return out
    if NP == 0:
        raise ValueError("paged_distance: empty page store")
    # a block walks a group of consecutive tiles (at least MQ query rows,
    # and few enough blocks that one wave of the card holds them all),
    # staging a page once per run of tiles that share it
    dc = _dchunk(P, d)
    group = max(MQ // QB, 1, -(-T // _resident_blocks(
        queries.device.index, P, dc)))
    # 16-byte copies: whole 16-byte runs of d (and of the d-chunk), and
    # aligned rows
    run = 8 if _BF16 in (queries.dtype, db.dtype) else 4
    vec = d % run == 0 and (dc >= d or dc % run == 0) and \
        queries.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0
    kernel.launch(page_ids.data_ptr(), queries.data_ptr(), qq.data_ptr(),
                  db.data_ptr(), vnorm.data_ptr(), out.data_ptr(),
                  T, QB, P, d, NP, dc, group, int(vec),
                  cost=lambda: cost(T, QB, P, d, NP,
                                    q_itemsize=queries.element_size(),
                                    db_itemsize=db.element_size()))
    return out
