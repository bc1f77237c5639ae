"""Paged SiN distance (§IV-C4) — the hand-written CUDA kernel's wrapper.

The paper's LUN-level accelerator reads one NAND page into the page
buffer and MACs a batch of queries against every vector in it. Here the
T * QB query rows are cut into one slice per thread block; a block walks
its slice in steps of query rows that share a page, staging the next
step's rows (and its page, when the page changes) while it computes the
current one, each (QB, d) query tile against the (P, d) page
``page_ids[t]`` of the paged store (``csrc/paged_distance.cu`` has the
design and what bounds it). :func:`launch_plan` sizes the launch from
the shapes and the card's SM count alone.

Distances use  q.q - 2 q.v + v.v ; qq and vnorm are precomputed.
Queries and store are f32 or bf16, in any pair: each pair is one
instantiation of the kernel, with a launch count of its own, and bf16
operands are staged raw and upcast to f32 as the kernel reads them (the
f32 result on the upcast operands, bit for bit).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

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
THREADS = 256                # the kernel's threads per block
MAX_BLOCKS_PER_SM = 2        # the kernel's __launch_bounds__
QTS = (1, 2, 4)              # query rows of a thread the kernel takes
STEP_ROWS = 32               # query rows of a step the small tiles aim at
WIDE_STEP_ROWS = 64          # ... and the wide (4 page row) tiles


class Plan(NamedTuple):
    """One launch: ``blocks`` slices of the T * QB query rows (at most
    ``rows_per_item`` each); a step of at most ``mq`` query rows against
    ``pt * npg`` page rows, a thread owning ``qt`` x ``pt`` of them (pt
    2: two page slots, the next page loading while a step computes; pt
    4: one f32 slot's bytes, which hold two slots of a bf16 page); d
    staged in chunks of ``dc`` (>= d: whole); ``smem`` bytes of shared
    memory a block."""
    blocks: int
    rows_per_item: int
    dc: int
    smem: int
    npg: int
    qt: int
    mq: int
    pt: int


def thread_tile(P: int, pt: int = 2,
                step: int = STEP_ROWS) -> tuple[int, int, int]:
    """(npg, qt, mq): a thread takes ``pt`` page rows r, r + npg, ...,
    ``npg`` page row groups (P / pt rounded up to a power of two, at most
    THREADS); THREADS / npg query groups of ``qt`` rows each; ``mq`` query
    rows a step, at most ``step`` where the groups allow (P 64: 4 x 2
    tiles over 32 rows at pt 2, 4 x 4 over 64 at pt 4; P 8: 1 x 2 tiles
    over 64 rows)."""
    npg = min(1 << max(0, (-(-P // pt) - 1).bit_length()), THREADS)
    nqg = THREADS // npg
    qt = max(q for q in QTS if q == 1 or nqg * q <= step)
    return npg, qt, nqg * qt


def smem_bytes(pt: int, npg: int, mq: int, dc: int) -> int:
    """Shared memory of one block: two slots of the page's ``pt * npg``
    rows at pt 2, one at pt 4, and two of ``mq`` query rows, at the
    kernel's f32 row pitch for d-chunk dc (a slot of bf16 rows takes no
    more)."""
    pslots = 2 if pt == 2 else 1
    return (pslots * pt * npg + 2 * mq) * 4 * ((dc // 4) | 1) * 4


@functools.lru_cache(maxsize=None)
def launch_plan(T: int, QB: int, P: int, d: int, sms: int) -> Plan:
    """The launch for these shapes on a card of ``sms`` SMs. Where every
    block of a wave has a full wide step of rows (the search's many tiles)
    and the page fits whole: 4 x 4 tiles over 64 rows a step, one page
    slot (two would leave one block to an SM). Else 2-page-row tiles over
    32 rows, two page slots, and the whole d (rounded up to 4) when they
    fit a block's share of an SM (MAX_BLOCKS_PER_SM blocks to an SM), else
    d in the fewest even chunks (multiples of 8) that fit it. As many
    blocks as fit on the card at once, fewer only when there are fewer
    query rows. Depends on the shapes alone, never on page ids."""
    share = SMEM_SM // MAX_BLOCKS_PER_SM - 1024
    rows = T * QB
    dc = max(4, -(-d // 4) * 4)
    npg, qt, mq = thread_tile(P, 4, WIDE_STEP_ROWS)
    wide = (P >= 32 and 4 * npg >= P
            and rows >= WIDE_STEP_ROWS * MAX_BLOCKS_PER_SM * sms
            and smem_bytes(4, npg, mq, dc) <= share)
    if wide:
        pt = 4
    else:
        pt, chunks = 2, 1
        npg, qt, mq = thread_tile(P)
        while smem_bytes(2, npg, mq, dc) > share and dc > 8:
            chunks += 1
            dc = -(-d // (8 * chunks)) * 8
    smem = smem_bytes(pt, npg, mq, dc)
    if smem > SMEM_MAX:
        raise ValueError(f"paged_distance: a page of {P} rows does not "
                         f"fit shared memory")
    per_sm = min(MAX_BLOCKS_PER_SM, SMEM_SM // (smem + 1024))
    blocks = max(1, min(per_sm * sms, rows))
    return Plan(blocks, -(-rows // blocks), dc, smem, npg, qt, mq, pt)


@functools.lru_cache(maxsize=None)
def _sms(device: int) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    plan = launch_plan(T, QB, P, d, _sms(queries.device.index))
    # 16-byte copies: whole 16-byte runs of d (and of the d-chunk), and
    # aligned rows
    run = 8 if _BF16 in (queries.dtype, db.dtype) else 4
    vec = d % run == 0 and (plan.dc >= d or plan.dc % run == 0) and \
        queries.data_ptr() % 16 == 0 and db.data_ptr() % 16 == 0
    kernel.launch(page_ids.data_ptr(), queries.data_ptr(), qq.data_ptr(),
                  db.data_ptr(), vnorm.data_ptr(), out.data_ptr(),
                  T, QB, P, d, NP, plan.dc, plan.blocks, plan.npg, plan.qt,
                  plan.pt, int(vec),
                  cost=lambda: cost(T, QB, P, d, NP,
                                    q_itemsize=queries.element_size(),
                                    db_itemsize=db.element_size()))
    return out
