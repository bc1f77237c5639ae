"""Pluggable kernel backend for the engine's two hot paths.

Every distance computation and every candidate merge in the port funnels
through a :class:`KernelBackend`, which owns

  * **mode selection** — ``auto | cuda | ref | torch``:

        oracle (core/ref_search.py, numpy)       — pure-python semantics
          -> ``torch``  inline torch ops         — gather + dot, two
                                                   stable sorts
          -> ``ref``    kernels/*/ref.py         — the kernels' plain
                                                   versions behind the
                                                   same tiling/padding
          -> ``cuda``   kernels/csrc/*.cu        — the hand-written
                                                   Hopper kernels

    ``auto`` resolves per call from the tensors it is given: ``cuda`` for
    CUDA tensors, ``ref`` for CPU tensors. ``cuda`` on a CPU tensor
    raises. All modes produce bit-identical results on integer-valued
    vectors.

  * **tile padding** — sort widths pad to the next power of two with
    (BIG_DIST, ID_SENTINEL) filler that lexicographically sorts after
    every real entry (kernels/topk/ops.py::sort_op).

  * **dispatch** for the two kernels:
      - paged SiN distance (kernels/distance) — one tile = one page read;
        assignments are regrouped by physical page, then packed into
        per-page query tiles of width ``coalesce_qb``: one page read
        serves up to that many same-page assignments (the Allocator's
        two-level scheduling).
      - lexicographic bitonic sort + merge (kernels/topk) — (dist, id)
        networks with any number of payload lanes. The engine's
        candidate-list merge is one fused op (``merge_gather``) that
        carries the ``expanded`` flags as bytes; the general
        ``sort_pairs``/``merge_pairs``/``merge_unsorted`` (the
        reference's call forms) pack bool payloads to i32.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.distance.ops import (coalesce_num_tiles,
                                              coalesced_distance_op,
                                              paged_distance_op)
from repro_torch.kernels.topk.ops import (merge_sorted_op, merge_unsorted_op,
                                          sort_op)
from repro_torch.kernels.topk.ref import lexsort_pairs
from repro_torch.utils import BIG_DIST, ID_SENTINEL, cdiv

MODES = ("auto", "cuda", "ref", "torch")
# minimum static page-reuse estimate (items / store pages) at which the
# coalesced query tiles engage; below it the per-item tiles run
COALESCE_MIN_REUSE = 2.0


def _pack(payload) -> tuple:
    return tuple(p.to(torch.int32) if p.dtype == torch.bool else p
                 for p in payload)


def _concat_rows(a: tuple, b: tuple) -> tuple:
    return tuple(torch.cat([x, y], dim=-1) for x, y in zip(a, b))


@dataclasses.dataclass(frozen=True)
class KernelBackend:
    """Mode selection + padding + dispatch for the hot kernels.

    mode         : see :data:`MODES`; ``auto`` resolves per call from the
                   device of the tensors it is given.
    coalesce_qb  : per-page query-tile width for ``item_distances``: up
                   to this many same-page assignments share one page
                   read. 0 keeps the per-item path (one tile per
                   assignment).
    """

    mode: str = "auto"
    coalesce_qb: int = 8

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"kernel mode {self.mode!r} not in {MODES}")
        if self.coalesce_qb < 0:
            raise ValueError(
                f"coalesce_qb must be >= 0, got {self.coalesce_qb}")

    @property
    def inline(self) -> bool:
        """True when hot paths use inline torch ops instead of the kernels."""
        return self.mode == "torch"

    def kernel_mode(self) -> str:
        """The mode handed to the kernel ops ('auto' resolves there; the
        inline mode's rare kernel-shaped calls take the plain version)."""
        return "ref" if self.inline else self.mode

    # -- merge/sort ---------------------------------------------------------
    def sort_pairs(self, dists, ids, *payload):
        """Ascending lexicographic (dist, id) row sort, payload carried.

        Ties — identical (dist, id) — must carry identical payloads for
        the bitonic network to agree with a stable sort; the engine
        guarantees this (duplicate ids never survive dedup, and sentinel
        slots are never marked expanded).
        """
        if self.inline:
            return lexsort_pairs(dists, ids, *payload)
        out = sort_op(dists, ids, *_pack(payload), mode=self.kernel_mode())
        return (out[0], out[1]) + tuple(
            o.to(p.dtype) for o, p in zip(out[2:], payload))

    def merge_pairs(self, d_a, i_a, d_b, i_b, pay_a: tuple = (),
                    pay_b: tuple = ()):
        """Merge two already (dist, id)-sorted row sets into sorted rows:
        a single bitonic merge pass over concat(A, reversed B) instead of
        re-running the full network on sorted data. Payload lanes pair up
        across the two sides."""
        if self.inline:
            return lexsort_pairs(*_concat_rows((d_a, i_a) + tuple(pay_a),
                                               (d_b, i_b) + tuple(pay_b)))
        out = merge_sorted_op(d_a, i_a, d_b, i_b, pay_a=_pack(pay_a),
                              pay_b=_pack(pay_b), mode=self.kernel_mode())
        return (out[0], out[1]) + tuple(
            o.to(p.dtype) for o, p in zip(out[2:], pay_a))

    def merge_unsorted(self, d_a, i_a, d_b, i_b, pay_a: tuple = (),
                       pay_b: tuple = ()):
        """Merge sorted rows A with **unsorted** rows B into sorted rows
        of width LA + LB, payload lanes carried (the reference's call
        form): kernel modes sort B (:meth:`sort_pairs`) and run one merge
        pass (:meth:`merge_pairs`); inline mode sorts the concatenation
        once."""
        if self.inline:
            return lexsort_pairs(*_concat_rows((d_a, i_a) + tuple(pay_a),
                                               (d_b, i_b) + tuple(pay_b)))
        sb = self.sort_pairs(d_b, i_b, *pay_b)
        return self.merge_pairs(d_a, i_a, sb[0], sb[1], pay_a=pay_a,
                                pay_b=tuple(sb[2:]))

    def merge_gather(self, d_a, i_a, e_a, d_b, i_b, valid_b, out_w: int):
        """The engine's Gather merge: sorted rows A with **unsorted**
        rows B into sorted rows — the candidate-list update's real shape
        — and keep the first ``out_w`` of each.

        d_a/i_a/e_a : (R, LA) sorted candidates and their expanded flags
        d_b/i_b     : (R, LB) unsorted proposals; where ``valid_b`` is
                      False they become (BIG_DIST, ID_SENTINEL). All
                      carry expanded = False.
        Kernel modes run the fused merge (mask, sort B with the bitonic
        network, one merge pass: one launch in cuda mode); inline mode
        sorts the concatenation once.
        """
        if not self.inline:
            return merge_unsorted_op(d_a, i_a, e_a, d_b, i_b, valid_b, out_w,
                                     mode=self.kernel_mode())
        d_b = torch.where(valid_b, d_b, BIG_DIST)
        i_b = torch.where(valid_b, i_b, ID_SENTINEL)
        out = lexsort_pairs(*_concat_rows((d_a, i_a, e_a),
                                          (d_b, i_b,
                                           torch.zeros_like(valid_b))))
        return tuple(x[:, :out_w] for x in out)

    # -- distance -----------------------------------------------------------
    def coalesce_active(self, items: int, npages: int) -> bool:
        """Whether ``item_distances`` packs per-page query tiles for
        ``items`` assignments over an ``npages``-page store: the static
        reuse estimate ``items / npages`` must clear
        :data:`COALESCE_MIN_REUSE`, else the per-item tiles run."""
        return (self.coalesce_qb > 0
                and items >= COALESCE_MIN_REUSE * max(1, npages))

    def distance_grid_steps(self, items: int, npages: int) -> int:
        """Tiles (page reads) ``item_distances`` launches in kernel modes
        for ``items`` assignments over ``npages`` pages (per shard)."""
        if self.coalesce_active(items, npages):
            return coalesce_num_tiles(items, npages, self.coalesce_qb)
        return items

    def coalesce_occupancy(self, items: int, npages: int) -> float:
        """Fraction of coalesced-tile query lanes holding a real
        assignment: ``items / (grid_steps * qb)``. 1.0 means every page
        read serves a full qb-wide tile; the per-item paths (qb == 0, or
        low reuse) are width-1 tiles, 1.0 by construction."""
        qb = self.coalesce_qb
        if qb <= 0 or items <= 0 or not self.coalesce_active(items,
                                                             npages):
            return 1.0
        return items / (self.distance_grid_steps(items, npages) * qb)

    def paged_distance(self, page_ids, queries, qq, db, vnorm):
        """(T, QB, d) query tiles x (NP, P, d) paged db -> (T, QB, P)."""
        return paged_distance_op(page_ids, queries, qq, db, vnorm,
                                 mode=self.kernel_mode())

    def item_distances(self, ppage, slot, mask, qvec, qq, db, vnorm):
        """Per-assignment squared-L2 distances where the vectors live.

        ppage/slot/mask/qq : (I,) physical page, slot-in-page, validity,
                             per-item query self-dot
        qvec               : (I, d) per-item query payload
        db, vnorm          : (NP, P, d), (NP, P) paged store
        returns            : (I,) f32; masked items get BIG_DIST.

        Every argument may lead with a shard axis S; kernel modes then
        tile each shard as the unbatched call would and launch once for
        all shards. Kernel modes regroup the assignments by physical page
        and pack them into per-page query tiles of width ``coalesce_qb``
        (one page read for up to qb assignments); ``coalesce_qb == 0`` or
        low page reuse runs width-1 tiles.
        """
        if self.inline:
            if ppage.dim() == 1:
                v, vn = db[ppage, slot], vnorm[ppage, slot]
            else:
                srow = torch.arange(ppage.shape[0], device=ppage.device)
                v = db[srow[:, None], ppage, slot]
                vn = vnorm[srow[:, None], ppage, slot]
            qv = (qvec.float() * v.float()).sum(-1)
            return torch.where(mask, (qq - 2.0 * qv) + vn, BIG_DIST)
        qb = (max(1, self.coalesce_qb)
              if self.coalesce_active(ppage.shape[-1], db.shape[-3]) else 1)
        return coalesced_distance_op(ppage, slot, mask, qvec, qq, db, vnorm,
                                     qb=qb, mode=self.kernel_mode())

    def translated_item_distances(self, ttab, ppage, slot, mask, qvec, qq,
                                  frames, vnorm):
        """:meth:`item_distances` through the tiered store's translation
        table (core/pagestore.py).

        ttab           : (NP,) or (S, NP) i32, logical page -> device
                         frame, -1 where the page is not resident
        frames, vnorm  : (P_dev, P, d), (P_dev, P), with the same leading
                         shard axis: the device frame buffer
        returns        : (dist (I,), resident (I,) bool). Resident
                         assignments read their frame exactly as
                         ``item_distances`` reads a full store;
                         non-resident ones read nothing (BIG_DIST) and are
                         reported so the owner query can stall.

        The coalescing decision sees ``npages = P_dev``, as the
        reference's does. With an identity table over a full store every
        argument to ``item_distances`` is the untranslated call's.
        """
        frame = ttab.gather(-1, ppage.long().clamp(0, ttab.shape[-1] - 1))
        resident = frame >= 0
        fpage = frame.long().clamp(0, frames.shape[-3] - 1)
        dist = self.item_distances(fpage, slot, mask & resident, qvec, qq,
                                   frames, vnorm)
        return dist, resident


def paged_view(db: torch.Tensor, vnorm: torch.Tensor, page_size: int):
    """Reshape a flat (N, d) store into the paged (NP, P, d) layout the
    SiN kernel reads, zero-padding the tail page."""
    n, d = db.shape
    npages = cdiv(n, page_size)
    pad = npages * page_size - n
    if pad:
        db = torch.cat([db, db.new_zeros((pad, d))], dim=0)
        vnorm = torch.cat([vnorm, vnorm.new_zeros((pad,))])
    return (db.reshape(npages, page_size, d),
            vnorm.reshape(npages, page_size))
