"""Paged SiN distance (§IV-C4) — the hand-written CUDA kernel's wrapper.

The paper's LUN-level accelerator reads one NAND page into the page
buffer and MACs a batch of queries against every vector in it. Here one
thread block is one page read: it serves a (QB, d) query tile against
the (P, d) page ``page_ids[t]`` of the paged store (``csrc/
paged_distance.cu`` has the design and what bounds it).

Distances use  q.q - 2 q.v + v.v ; qq and vnorm are precomputed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import Kernel, check_cuda_operands
from repro_torch.kernels.distance.ref import paged_distances_ref

KERNEL = Kernel(name="paged_distance", source="paged_distance.cu",
                entry="paged_distance_launch",
                replaces="src/repro/kernels/distance/kernel.py:40")

THREADS = 256
SMEM_LIMIT = 48 * 1024        # static-launch shared memory per block
MAX_DCHUNK = 32


def _dchunk(qb: int, p: int) -> int:
    """Widest d-chunk (<= 32) whose query + page staging fits the block's
    shared memory (rows padded by one word)."""
    dc = MAX_DCHUNK
    while dc >= 1 and (qb + p) * (dc + 1) * 4 > SMEM_LIMIT:
        dc //= 2
    if dc < 1:
        raise ValueError(f"paged_distance: a page of {p} rows plus a "
                         f"{qb}-row query tile does not fit shared memory")
    return dc


def paged_distances(page_ids: torch.Tensor, queries: torch.Tensor,
                    qq: torch.Tensor, db: torch.Tensor,
                    vnorm: torch.Tensor) -> torch.Tensor:
    """Per-tile query->page squared-L2 distances.

    page_ids : (T,)        i32  page read per tile
    queries  : (T, QB, d)  f32  query tiles (dispatcher-grouped)
    qq       : (T, QB)     f32  per-query self dot
    db       : (NP, P, d)  f32  paged vector store
    vnorm    : (NP, P)     f32  per-vector self dot
    returns  : (T, QB, P)  f32

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (f32 only — a bf16 store raises) or raise.
    """
    if not queries.is_cuda:
        return paged_distances_ref(page_ids, queries, qq, db, vnorm)
    T, QB, d = queries.shape
    NP, P = db.shape[0], db.shape[1]
    f32 = torch.float32
    check_cuda_operands("paged_distance", {
        "page_ids": (page_ids, torch.int32, (T,)),
        "queries": (queries, f32, (T, QB, d)),
        "qq": (qq, f32, (T, QB)),
        "db": (db, f32, (NP, P, d)),
        "vnorm": (vnorm, f32, (NP, P)),
    })
    out = torch.empty((T, QB, P), dtype=f32, device=queries.device)
    if T == 0 or QB == 0 or P == 0:
        return out
    if NP == 0:
        raise ValueError("paged_distance: empty page store")
    threads = min(THREADS, max(32, -(-(QB * P) // 32) * 32))
    KERNEL.launch(page_ids.data_ptr(), queries.data_ptr(), qq.data_ptr(),
                  db.data_ptr(), vnorm.data_ptr(), out.data_ptr(),
                  T, QB, P, d, NP, _dchunk(QB, P), threads)
    return out
