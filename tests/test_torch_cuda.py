"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc, to build the kernels at
first use): they carry the ``cuda`` marker and skip without a card. Run
them on a GPU machine with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. This file imports only the port.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.capture import CACHE, CaptureCache
from repro_torch.core.engine import (SEARCH_CHUNK, EngineParams,
                                     pack_for_engine, search_sim)
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import stream_search
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.distance import (paged_distances,
                                          paged_distances_ref)
from repro_torch.kernels.distance.kernel import KERNEL as DIST
from repro_torch.kernels.distance.kernel import KERNELS as DISTS
from repro_torch.kernels.flash_attention import (attention_op, attention_ref,
                                                 flash_attention)
from repro_torch.kernels.flash_attention.kernel import KERNEL as FLASH
from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                      bitonic_sort, bitonic_sort_ref,
                                      merge_sorted_op, merge_unsorted,
                                      merge_unsorted_op, merge_unsorted_ref,
                                      sort_op)
from repro_torch.kernels.topk.kernel import MERGE_UNSORTED_KERNEL as FUSED
from repro_torch.utils import BIG_DIST, ID_SENTINEL

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _page_ids(T, NP, order, g, dev):
    """Page ids in the dispatcher's order ("sorted"), in none ("random"),
    or in runs of 1 to 33 tiles that cross the kernel's tile groups
    ("runs")."""
    if order == "runs":
        lens = torch.tensor([1, 5, 9, 17, 3, 33, 2, 8, 16, 7], device=dev)
        ids = torch.repeat_interleave(torch.arange(lens.numel(), device=dev)
                                      % NP, lens)
        return ids.repeat(-(-T // ids.numel()))[:T].int()
    pid = torch.randint(0, NP, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    return torch.sort(pid).values if order == "sorted" else pid


def _dist_case(T, QB, P, d, NP, dev, integer, seed=0, order="random"):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        q = torch.randint(-8, 9, (T, QB, d), generator=g, device=dev).float()
        db = torch.randint(-8, 9, (NP, P, d), generator=g, device=dev).float()
    else:
        q = torch.randn((T, QB, d), generator=g, device=dev)
        db = torch.randn((NP, P, d), generator=g, device=dev)
    pid = _page_ids(T, NP, order, g, dev)
    return pid, q, (q * q).sum(-1), db, (db * db).sum(-1)


@pytest.mark.parametrize("T,QB,P,d,NP,order", [
    (1, 8, 128, 128, 2, "random"), (4, 16, 256, 128, 8, "random"),
    (7, 8, 128, 64, 3, "random"), (16, 32, 128, 256, 4, "random"),
    (540, 8, 64, 128, 32, "random"), (9, 1, 64, 784, 5, "random"),
    (1, 1, 64, 64, 1, "random"),            # a single tile
    (540, 8, 64, 128, 32, "sorted"),        # long runs, as dispatched
    (200, 8, 64, 128, 4, "runs"),           # runs across tile groups
    (70, 1, 64, 128, 6, "runs"), (33, 16, 128, 64, 5, "runs"),
    (19, 32, 256, 128, 3, "sorted"),
    (12, 8, 256, 784, 3, "runs"),           # d in chunks, 4 task passes
    (40, 8, 64, 784, 3, "sorted"),
    (10, 3, 17, 30, 4, "runs"),             # odd P, d % 4 != 0
    (8, 2048, 8, 128, 8, "sorted"),         # the router's shape
    (456, 8, 64, 128, 192, "sorted"),       # the tiered sessions' shape
    (8, 1000, 8, 128, 8, "random"),         # QB not a multiple of a step
    (12, 512, 17, 128, 5, "runs"),          # P 17 at QB 512
    (4, 512, 64, 784, 3, "sorted"),         # d in chunks at QB 512
    (4320, 8, 64, 128, 256, "sorted"),      # the search's shape: 4 x 4
    (2200, 8, 64, 128, 300, "random"),      # 4 x 4, a page most steps
    (600, 32, 128, 64, 20, "runs"),         # 4 x 4 at P 128
    (2200, 8, 33, 30, 40, "runs"),          # 4 x 4, odd P, d % 4 != 0
])
@pytest.mark.parametrize("integer", [True, False])
def test_paged_distance_matches_plain(dev, T, QB, P, d, NP, order, integer):
    args = _dist_case(T, QB, P, d, NP, dev, integer, order=order)
    out = paged_distances(*args)
    ref = paged_distances_ref(*args)
    torch.cuda.synchronize()
    if integer:   # every f32 step exact: any evaluation order agrees
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:         # summation order (FMA chain vs batched product)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_paged_distance_rejects_bf16_and_cpu_mix(dev):
    """q and db may be bf16; qq and vnorm stay f32, and other types and a
    CPU operand beside CUDA ones raise."""
    pid, q, qq, db, vn = _dist_case(2, 8, 64, 32, 2, dev, True)
    for bad in ((pid, q, qq.bfloat16(), db, vn),
                (pid, q, qq, db, vn.bfloat16()),
                (pid, q.half(), qq, db, vn), (pid, q, qq, db.half(), vn)):
        with pytest.raises(TypeError):
            paged_distances(*bad)
    with pytest.raises(ValueError):
        paged_distances(pid.cpu(), q, qq, db, vn)
    with pytest.raises(ValueError):
        paged_distances(pid, q.bfloat16(), qq, db.bfloat16().cpu(), vn)


@pytest.mark.parametrize("T,QB,P,d,NP,order", [
    (540, 8, 64, 128, 32, "sorted"),        # the search path's tiles
    (200, 8, 64, 128, 4, "runs"),
    (12, 8, 256, 784, 3, "runs"),           # d in chunks (of 452: 4-wide)
    (10, 3, 17, 30, 4, "runs"),             # d % 4 != 0: one per load
    (9, 4, 32, 36, 5, "random"),            # d % 8 != 0: one per load
    (33, 16, 128, 64, 5, "sorted"),
    (8, 2048, 8, 128, 8, "sorted"),         # the router's shape
    (456, 8, 64, 128, 192, "sorted"),       # the tiered sessions' shape
    (8, 1000, 8, 128, 8, "random"),         # QB not a multiple of a step
    (12, 512, 17, 128, 5, "runs"),          # P 17 at QB 512
    (4, 512, 64, 784, 3, "sorted"),         # d in chunks at QB 512
    (4320, 8, 64, 128, 256, "sorted"),      # the search's shape: 4 x 4
    (2200, 8, 64, 128, 300, "random"),      # 4 x 4, a page most steps
    (2200, 8, 33, 36, 40, "runs"),          # 4 x 4, d % 8 != 0
])
@pytest.mark.parametrize("qt,dt", [("bf16", "f32"), ("f32", "bf16"),
                                   ("bf16", "bf16")])
@pytest.mark.parametrize("integer", [True, False])
def test_paged_distance_bf16_equals_f32_on_upcast(dev, T, QB, P, d, NP,
                                                   order, qt, dt, integer):
    """A bf16 operand is upcast exactly as it is staged: the bf16
    instantiation gives the f32 kernel's bits on the upcast operands,
    and equals its plain version (exactly on integer inputs), launching
    its own instantiation once."""
    pid, q, qq, db, vn = _dist_case(T, QB, P, d, NP, dev, integer,
                                    order=order)
    bf = {"bf16": torch.bfloat16, "f32": torch.float32}
    q, db = q.to(bf[qt]), db.to(bf[dt])
    qq, vn = (q.float() ** 2).sum(-1), (db.float() ** 2).sum(-1)
    reset_launch_counts()
    out = paged_distances(pid, q, qq, db, vn)
    counts = launch_counts()
    want = paged_distances(pid, q.float(), qq, db.float(), vn)
    ref = paged_distances_ref(pid, q, qq, db, vn)
    torch.cuda.synchronize()
    name = DISTS[(q.dtype, db.dtype)].name
    assert counts[name] == 1 and counts["paged_distance"] == 0
    torch.testing.assert_close(out.view(torch.int32), want.view(torch.int32),
                               rtol=0, atol=0)
    if integer:
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_paged_distance_refused_launch_raises(dev):
    pid, q, qq, db, vn = _dist_case(2, 8, 64, 32, 2, dev, True)
    out = torch.empty((2, 8, 64), device=dev)
    before = DIST.launches
    # an empty grid; shared memory > max; thread tiles with no kernel;
    # a d-chunk of bf16 not whole 16-byte runs
    for blocks, dc, npg, qt, pt in ((0, 32, 32, 4, 2), (2, 4096, 32, 4, 2),
                                    (2, 32, 24, 4, 2), (2, 32, 32, 8, 2),
                                    (2, 32, 16, 4, 3), (2, 12, 32, 4, 2)):
        with pytest.raises(RuntimeError, match="cudaError"):
            DIST.launch(pid.data_ptr(), q.data_ptr(), qq.data_ptr(),
                        db.data_ptr(), vn.data_ptr(), out.data_ptr(), 2, 8,
                        64, 32, 2, dc, blocks, npg, qt, pt, 1)
    assert DIST.launches == before
    out = paged_distances(pid, q, qq, db, vn)     # no error left behind
    torch.testing.assert_close(out, paged_distances_ref(pid, q, qq, db, vn),
                               rtol=0, atol=0)


@pytest.mark.parametrize("T,QB,P,d,NP", [
    (456, 8, 64, 128, 192),                 # the tiered sessions' shape
    (8, 2048, 8, 128, 8),                   # the router's shape
    (4, 512, 64, 784, 3),                   # d in chunks
    (4320, 8, 64, 128, 256),                # the search's shape: 4 x 4
])
def test_paged_distance_graph_replay_equals_eager(dev, T, QB, P, d, NP):
    """A launch recorded in a CUDA graph replays to the eager launch's
    bits, also after its page ids and queries change in place (the grid
    comes from the shapes; the kernel reads the ids on the card); each
    call is one launch, counted where it runs."""
    args = _dist_case(T, QB, P, d, NP, dev, False, order="sorted")
    reset_launch_counts()
    eager = paged_distances(*args)
    assert DIST.launches == 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm-up off the capture
        paged_distances(*args)
    torch.cuda.current_stream().wait_stream(side)
    recorded = DIST.recorded
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = paged_distances(*args)
    assert DIST.recorded == recorded + 1 and DIST.launches == 2
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), eager.view(torch.int32))
    new = _dist_case(T, QB, P, d, NP, dev, False, seed=1, order="runs")
    for a, b in zip(args, new):
        a.copy_(b)
    graph.replay()
    want = paged_distances(*new)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    torch.testing.assert_close(out, paged_distances_ref(*new), rtol=1e-5,
                               atol=1e-4)
    assert DIST.launches == 3


def _rows(B, M, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 6, (B, M), generator=g, device=dev).float()  # ties
    i = torch.argsort(torch.rand((B, M), generator=g, device=dev), -1)
    p = torch.randint(0, 2, (B, M), generator=g, device=dev)
    return d, i.int(), p.int()


def _bits_equal(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:     # -0.0 and NaN compare by bits
            g, w = g.view(torch.int32), w.view(torch.int32)
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("B,M", [(256, 16), (256, 64), (3, 1), (5, 2),
                                 (2, 2048), (300, 32), (7, 128), (9, 256)])
def test_bitonic_sort_matches_plain(dev, B, M):
    """Both bodies (registers up to M 128, shared memory beyond, or at
    any width when asked) against the plain version and each other."""
    d, i, p = _rows(B, M, dev, seed=M)
    for got, want in ((bitonic_sort(d, i, p), bitonic_sort_ref(d, i, p)),
                      (bitonic_sort(d, i), bitonic_sort_ref(d, i)),
                      (bitonic_sort(d, i, p, shared=True),
                       bitonic_sort_ref(d, i, p))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("B,M", [(256, 16), (256, 64), (33, 128), (5, 2048)])
def test_bitonic_bodies_agree_on_ties_and_special_values(dev, B, M):
    """Exact (dist, id) ties with differing payloads, -0.0 / 0.0 and NaN:
    the register body gives the shared-memory body's bits, the sort
    gives the plain version's stable, NaN-last order, and the merge pass
    the plain network's IEEE compares."""
    d, i, p = _rows(B, M, dev, seed=M + 1)
    i = i % max(1, M // 4)
    d[:, 0], d[:, 1], i[:, 1] = -0.0, 0.0, i[:, 0]
    d[:, 2], d[:, 3] = float("nan"), float("inf")
    for fn in (bitonic_sort, bitonic_merge):
        _bits_equal(fn(d, i, p), fn(d, i, p, shared=True))
    _bits_equal(bitonic_sort(d, i, p), bitonic_sort_ref(d, i, p))
    _bits_equal(bitonic_merge(d, i, p), bitonic_merge_ref(d, i, p))


@pytest.mark.parametrize("la,lb", [(32, 16), (13, 10), (3, 29), (1000, 1000)])
def test_bitonic_merge_matches_plain(dev, la, lb):
    B = 64
    da, ia, pa = bitonic_sort_ref(*_rows(B, la, dev, la))
    db, ib, _ = bitonic_sort_ref(*_rows(B, lb, dev, lb + 1))
    ib = ib + la                                        # distinct ids
    pb = torch.zeros_like(ib)
    got = merge_sorted_op(da, ia, db, ib, (pa,), (pb,), mode="cuda")
    want = merge_sorted_op(da, ia, db, ib, (pa,), (pb,), mode="ref")
    full = bitonic_sort_ref(torch.cat([da, db], 1), torch.cat([ia, ib], 1),
                            torch.cat([pa, pb], 1))
    for g, w, f in zip(got, want, full):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
        torch.testing.assert_close(g, f, rtol=0, atol=0)


def test_bitonic_merge_wrapper_on_bitonic_rows(dev):
    d, i, p = _rows(128, 64, dev, seed=3)
    d, i, p = bitonic_sort_ref(d, i, p)
    d, i, p = (torch.cat([x[:, :32], x[:, 32:].flip(1)], 1) for x in (d, i, p))
    for g, w in zip(bitonic_merge(d, i, p), bitonic_merge_ref(d, i, p)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _gather_case(R, la, lb, dev, seed, special=False):
    """Sorted candidates with expanded flags (sentinel tail), unsorted
    proposals with ties against the candidates, duplicates and invalid
    entries; row 0 all invalid, row 1 all valid."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cd, ci, ce = bitonic_sort_ref(*_rows(R, la, dev, seed))
    ce = ce.bool()
    tail = la - la // 4
    cd[:, tail:], ci[:, tail:], ce[:, tail:] = BIG_DIST, ID_SENTINEL, False
    nd = torch.randint(0, 6, (R, lb), generator=g, device=dev).float()
    ni = torch.randint(0, la + lb, (R, lb), generator=g, device=dev).int()
    nv = torch.rand((R, lb), generator=g, device=dev) < 0.7
    nv[0], nv[min(1, R - 1)] = False, True
    if special and lb >= 4:
        nd[:, 0], nd[:, 1], ni[:, 1] = -0.0, 0.0, ni[:, 0]
        nd[:, 2], nd[:, 3] = float("nan"), float("inf")
    return cd, ci.contiguous(), ce, nd, ni, nv


def _two_launch(cd, ci, ce, nd, ni, nv, out_w):
    """The two-launch composition on the card: bitonic_sort of the masked
    proposals, then bitonic_merge of A ++ filler ++ reversed(B)."""
    sd, si = sort_op(torch.where(nv, nd, BIG_DIST),
                     torch.where(nv, ni, ID_SENTINEL), mode="cuda")
    d, i, e = merge_sorted_op(cd, ci, sd, si, (ce.int(),),
                              (torch.zeros_like(si),), mode="cuda")
    return d[:, :out_w], i[:, :out_w], e[:, :out_w] != 0


@pytest.mark.parametrize("R,la,lb", [(256, 32, 16), (255, 32, 16),
                                     (64, 13, 10), (8, 3, 29), (50, 1, 1),
                                     (40, 100, 28), (6, 1500, 548),
                                     (4, 1024, 1024)])
def test_merge_unsorted_matches_plain_and_two_launches(dev, R, la, lb):
    """The fused Gather merge, register body (LA + LB <= 128) and
    shared-memory body, against its plain version, the two-launch cuda
    composition and the other body, at out_w = LA and LA + LB."""
    case = _gather_case(R, la, lb, dev, seed=la + lb)
    for out_w in (la, la + lb):
        before = FUSED.launches
        got = merge_unsorted(*case, out_w)
        assert FUSED.launches == before + 1
        _bits_equal(got, merge_unsorted_ref(*case, out_w))
        _bits_equal(got, _two_launch(*case, out_w))
        _bits_equal(got, merge_unsorted(*case, out_w, shared=True))
        _bits_equal(got, merge_unsorted_op(*case, out_w, mode="cuda"))


@pytest.mark.parametrize("R,la,lb", [(256, 32, 16), (9, 1000, 40)])
def test_merge_unsorted_special_values_match_two_launches(dev, R, la, lb):
    """-0.0 beside 0.0 on one id, NaN and inf among the proposals: the
    fused merge, the two-launch composition, the other body and the
    plain version (a NaN proposal sorts after every number) agree."""
    case = _gather_case(R, la, lb, dev, seed=3, special=True)
    got = merge_unsorted(*case, la)
    _bits_equal(got, _two_launch(*case, la))
    _bits_equal(got, merge_unsorted(*case, la, shared=True))
    _bits_equal(got, merge_unsorted_ref(*case, la))


def test_merge_unsorted_rejects_bad_operands(dev):
    cd, ci, ce, nd, ni, nv = _gather_case(8, 32, 16, dev, seed=0)
    before = FUSED.launches
    with pytest.raises(TypeError):
        merge_unsorted(cd, ci.long(), ce, nd, ni, nv, 32)
    with pytest.raises(TypeError):
        merge_unsorted(cd, ci, ce.int(), nd, ni, nv, 32)
    with pytest.raises(ValueError, match="contiguous"):
        merge_unsorted(cd, ci, ce, nd.t().contiguous().t(), ni, nv, 32)
    with pytest.raises(ValueError):
        merge_unsorted(cd, ci, ce, nd, ni, nv.cpu(), 32)
    with pytest.raises(ValueError, match="out_w"):
        merge_unsorted(cd, ci, ce, nd, ni, nv, 49)
    assert FUSED.launches == before


def test_sort_rejects_bad_widths(dev):
    d, i, p = _rows(2, 4096, dev, seed=0)
    with pytest.raises(ValueError):
        bitonic_sort(d, i, p)
    with pytest.raises(ValueError):
        bitonic_sort(d[:, :24], i[:, :24])
    with pytest.raises(TypeError, match="i32/f32"):
        sort_op(d[:, :16], i[:, :16], p[:, :16].long(), mode="cuda")


def _lanes(B, M, dev, seed, dtypes):
    """Payload lanes of the given dtypes; f32 lanes hold NaN payloads
    (two bit patterns), -0.0 and 0.0, to be moved bit for bit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for dt in dtypes:
        x = torch.randint(-2**31, 2**31 - 1, (B, M), generator=g,
                          device=dev, dtype=torch.int32)
        if dt == torch.float32 and M >= 4:
            x = x.view(torch.float32)
            x[:, 0], x[:, 1] = -0.0, 0.0
            x[:, 2] = float("nan")
            x[:, 3] = torch.tensor(0x7fc00123, dtype=torch.int32).view(
                torch.float32)
        out.append(x.view(dt))
    return out


@pytest.mark.parametrize("B,M,nl", [(2048, 32, 3), (2048, 256, 3),
                                    (5, 2, 2), (33, 128, 4), (3, 2048, 2),
                                    (64, 64, 40)])
def test_bitonic_payload_lanes_match_plain(dev, B, M, nl):
    """Any number of i32 and f32 payload lanes (40: ten launches)
    in both bodies, the sort and the merge pass, bit for bit against the
    plain versions; ties with differing payloads included, and one f32
    lane alone."""
    from repro_torch.kernels.topk.kernel import MAX_LANES, SORT_KERNEL
    d, i, _ = _rows(B, M, dev, seed=M + nl)
    i = i % max(1, M // 4)
    lanes = _lanes(B, M, dev, nl, [(torch.int32, torch.float32)[k % 2]
                                   for k in range(nl)])
    before = SORT_KERNEL.launches
    got = bitonic_sort(d, i, *lanes)
    assert SORT_KERNEL.launches == before + -(-nl // MAX_LANES)
    _bits_equal(got, bitonic_sort_ref(d, i, *lanes))
    _bits_equal(got, bitonic_sort(d, i, *lanes, shared=True))
    _bits_equal(bitonic_sort(d, i, lanes[1]),
                bitonic_sort_ref(d, i, lanes[1]))
    bd, bi, *bl = bitonic_sort_ref(d, i, *lanes)
    h = M // 2
    row = [torch.cat([x[:, :h], x[:, h:].flip(1)], 1) for x in [bd, bi, *bl]]
    got = bitonic_merge(*row)
    _bits_equal(got, bitonic_merge_ref(*row))
    _bits_equal(got, bitonic_merge(*row, shared=True))


def test_merge_sorted_op_two_lanes_on_card(dev):
    """merge_sorted_op at M 64 with an i32 and an f32 lane, and the
    backend's reference call forms (sort_pairs, merge_pairs,
    merge_unsorted) with mixed lanes: the card's bits are ref mode's."""
    from repro_torch.core.backend import KernelBackend
    B = 2048
    da, ia, _ = bitonic_sort_ref(*_rows(B, 32, dev, 1))
    db, ib, _ = bitonic_sort_ref(*_rows(B, 32, dev, 2))
    pa = _lanes(B, 32, dev, 3, (torch.int32, torch.float32))
    pb = _lanes(B, 32, dev, 4, (torch.int32, torch.float32))
    _bits_equal(merge_sorted_op(da, ia, db, ib, pa, pb, mode="cuda"),
                merge_sorted_op(da, ia, db, ib, pa, pb, mode="ref"))
    cuda, ref = KernelBackend(mode="cuda"), KernelBackend(mode="ref")
    e = (pa[0] > 0)
    _bits_equal(cuda.sort_pairs(db, ib, pb[1], e),
                ref.sort_pairs(db, ib, pb[1], e))
    _bits_equal(cuda.merge_unsorted(da, ia, db.flip(1), ib, pa, pb),
                ref.merge_unsorted(da, ia, db.flip(1), ib, pa, pb))


def _search_index(dev):
    rng = np.random.default_rng(0)
    n, dim, S = 512, 16, 4
    db = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(32, dim)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, seed=0)
    geo = Geometry(num_shards=S, page_size=16, pages_per_block=2, dim=dim)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=4), max_degree=8)
    return packed, queries.reshape(S, -1, dim)


@pytest.mark.parametrize("spec", [0, 4])
def test_search_sim_cuda_matches_cpu_ref(dev, spec):
    """search_sim captured on the card == run eagerly on the card == CPU
    ref mode, bit for bit; one capture, then one replay per chunk, and
    the kernels' launches equal the rounds the device ran (the eager
    warm-up's and every replay's SEARCH_CHUNK masked rounds)."""
    packed, qsh = _search_index(dev)
    out = {}
    for name, mode, where, capture in (
            ("captured", "cuda", dev, True), ("eager", "cuda", dev, False),
            ("ref", "ref", "cpu", True)):
        params = EngineParams.lossless(SearchParams(L=16, W=2, k=10),
                                       qsh.shape[1], 8, spec_width=spec,
                                       kernel_mode=mode)
        consts, geom, entry = pack_for_engine(packed, device=where)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                    device=where, capture=capture)
        out[name] = (ids.cpu(), dists.cpu(),
                     {k: v.cpu() for k, v in st.items() if k != "host_syncs"})
        rounds = int(st["total_rounds"].max())
        counts = launch_counts()
        assert counts["bitonic_sort"] == counts["bitonic_merge"] == 0
        if name == "captured":
            assert st["host_syncs"] == -(-rounds // SEARCH_CHUNK)
            assert CACHE.stats.captures == 1
            assert CACHE.stats.replays == st["host_syncs"]
            device_rounds = SEARCH_CHUNK * (1 + st["host_syncs"])
            assert CACHE.stats.rounds == device_rounds
            assert counts["paged_distance"] == device_rounds
            assert counts["bitonic_merge_unsorted"] == device_rounds
        elif name == "eager":   # every chunk's K rounds, none captured
            assert CACHE.stats.replays == 0
            assert counts["bitonic_merge_unsorted"] == \
                SEARCH_CHUNK * st["host_syncs"]
    for name in ("captured", "eager"):
        for a, b in zip(out[name][:2], out["ref"][:2]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        for k, v in out["ref"][2].items():
            torch.testing.assert_close(out[name][2][k], v, rtol=0, atol=0)


def test_search_sim_replays_its_capture(dev):
    """A second search with the same shapes replays the first one's
    graph (no new capture) and returns its own results, not the
    graph's buffers."""
    packed, qsh = _search_index(dev)
    params = EngineParams.lossless(SearchParams(L=16, W=1, k=10),
                                   qsh.shape[1], 8)
    consts, geom, entry = pack_for_engine(packed, device=dev)
    first = search_sim(consts, qsh, *entry, params, geom, device=dev)
    CACHE.reset_stats()
    second = search_sim(consts, qsh[:, ::-1].copy(), *entry, params, geom,
                        device=dev)
    assert CACHE.stats.captures == 0 and CACHE.stats.replays > 0
    again = search_sim(consts, qsh, *entry, params, geom, device=dev)
    torch.testing.assert_close(first[0], again[0], rtol=0, atol=0)
    torch.testing.assert_close(first[0].flip(1), second[0], rtol=0, atol=0)


@pytest.fixture(scope="module")
def int_index():
    """An integer-valued index with prefetch lists (speculation)."""
    rng = np.random.default_rng(1)
    n, dim, S = 1024, 32, 4
    db = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(48, dim)).astype(np.float32)
    adj, medoid = build_vamana(db, r=12, seed=1)
    geo = Geometry(num_shards=S, page_size=32, pages_per_block=2, dim=dim)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=8), max_degree=12)
    return packed, queries


@pytest.mark.parametrize("spec,injit,dynamic", [
    (0, True, False), (4, True, False), (4, True, True), (0, False, False),
    (4, False, True)])
def test_stream_search_cuda_matches_cpu_ref(dev, int_index, spec, injit,
                                            dynamic):
    """The scheduler's chunks captured on the card == run eagerly on the
    card == CPU ref mode on an integer index: ids, dists, every
    per-query record but its wall time, and the round schedule; one read
    per chunk; one capture of the session's chunk program."""
    packed, queries = int_index
    arrivals = np.random.default_rng(2).integers(0, 30, len(queries))
    out = {}
    for name, mode, where, capture in (
            ("captured", "cuda", dev, True), ("eager", "cuda", dev, False),
            ("ref", "ref", "cpu", True)):
        params = EngineParams.lossless(SearchParams(L=16, W=1, k=10), 3, 12,
                                       spec_width=spec, kernel_mode=mode,
                                       deadline_rounds=40)
        consts, geom, entry = pack_for_engine(packed, device=where)
        CACHE.reset_stats()
        ids, dists, st = stream_search(
            consts, geom, params, entry, queries, num_slots=3,
            arrivals=arrivals, round_chunk=8, injit_admit=injit,
            dynamic_spec=dynamic, device=where, capture=capture)
        assert st.host_syncs == st.host_dispatches
        if name == "captured":
            assert CACHE.stats.captures == 1
            assert CACHE.stats.replays == st.host_dispatches + 1  # warmup
        out[name] = (ids, dists, {r.qid: (tuple(r.ids), tuple(r.dists),
                                          r.admit_round, r.retire_round,
                                          r.service_rounds, r.n_dist,
                                          r.truncated) for r in st.results},
                     st.total_rounds, st.occupancy_trace, st.spec_trace,
                     st.host_dispatches)
    for name in ("captured", "eager"):
        np.testing.assert_array_equal(out[name][0], out["ref"][0])
        np.testing.assert_array_equal(out[name][1].view(np.int32),
                                      out["ref"][1].view(np.int32))
        assert out[name][2:] == out["ref"][2:]


@pytest.mark.parametrize("refill", [True, False])
def test_stream_search_launches_fused_merge_once_per_round(dev, int_index,
                                                          refill):
    """Launch accounting under capture: every round the device ran —
    the capture's eager warm-up and each replay's K masked rounds, dead
    ones included — launches the distance kernel and the fused Gather
    merge once each, and the standalone sort and merge never. The live
    rounds (served and warmup) are at most those; one read per chunk."""
    packed, queries = int_index
    consts, geom, entry = pack_for_engine(packed, device=dev)
    params = EngineParams.lossless(SearchParams(L=16, W=1, k=10), 4, 12,
                                   spec_width=4)
    arrivals = np.random.default_rng(4).integers(0, 20, len(queries))
    reset_launch_counts()
    CACHE.reset_stats()
    _, _, st = stream_search(consts, geom, params, entry, queries,
                             num_slots=4, arrivals=arrivals, round_chunk=8,
                             refill=refill, device=dev)
    counts = launch_counts()
    device_rounds = 8 * (CACHE.stats.captures + CACHE.stats.replays)
    assert CACHE.stats.rounds == device_rounds
    assert counts["paged_distance"] == device_rounds
    assert counts["bitonic_merge_unsorted"] == device_rounds
    assert counts["bitonic_sort"] == counts["bitonic_merge"] == 0
    assert st.total_rounds + st.warmup_rounds <= device_rounds
    assert st.host_syncs == st.host_dispatches == CACHE.stats.replays - 1


@pytest.mark.parametrize("variant", ["gather_vectors", "payload_bf16"])
def test_search_sim_variants_cuda_match_cpu_ref(dev, variant):
    """The engine's variants captured on the card == CPU ref mode, bit
    for bit, with their launch accounting: the gather_vectors baseline
    runs no distance kernel (the fused Gather merge once per device
    round), payload_bf16 the distance kernel's bf16-query instantiation
    once per device round (the f32 one never)."""
    packed, qsh = _search_index(dev)
    out = {}
    for name, mode, where in (("captured", "cuda", dev),
                              ("ref", "ref", "cpu")):
        params = EngineParams.lossless(SearchParams(L=16, W=2, k=10),
                                       qsh.shape[1], 8, kernel_mode=mode,
                                       **{variant: True})
        consts, geom, entry = pack_for_engine(packed, device=where)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                    device=where)
        out[name] = (ids.cpu(), dists.cpu(),
                     {k: v.cpu() for k, v in st.items() if k != "host_syncs"})
        if name == "captured":
            counts = launch_counts()
            device_rounds = CACHE.stats.rounds
            assert device_rounds == SEARCH_CHUNK * (1 + st["host_syncs"])
            assert counts["bitonic_merge_unsorted"] == device_rounds
            bf16q = device_rounds if variant == "payload_bf16" else 0
            assert counts["paged_distance_bf16q"] == bf16q
            assert counts["paged_distance"] == 0
    for a, b in zip(out["captured"][:2], out["ref"][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out["ref"][2].items():
        torch.testing.assert_close(out["captured"][2][k], v, rtol=0, atol=0)


@pytest.mark.parametrize("plan", ["delay", "kill", "corrupt_guarded",
                                  "corrupt_nan_unguarded"])
def test_stream_fault_plans_cuda_match_cpu_ref(dev, int_index, plan):
    """Fault plans in the captured stream chunks (the stall windows read
    the device's round counter; the corruption hash runs on the card)
    == CPU ref mode on the integer index, per query and in the
    quarantined count."""
    from repro_torch.ft.inject import fault_plan
    packed, queries = int_index
    arrivals = np.random.default_rng(2).integers(0, 30, len(queries))
    faults = {"delay": fault_plan(4).delay(0, 3, 6).delay(2, 9, 4),
              "kill": fault_plan(4).kill(1, 5),
              "corrupt_guarded": fault_plan(4).corrupt(0.08, "neg", seed=3),
              "corrupt_nan_unguarded": fault_plan(4).corrupt(0.08, "nan",
                                                             seed=3)}
    out = {}
    for name, mode, where in (("captured", "cuda", dev),
                              ("ref", "ref", "cpu")):
        params = EngineParams.lossless(
            SearchParams(L=16, W=1, k=10), 3, 12, kernel_mode=mode,
            deadline_rounds=30, faults=faults[plan],
            guard_nonfinite=plan == "corrupt_guarded")
        consts, geom, entry = pack_for_engine(packed, device=where)
        ids, dists, st = stream_search(consts, geom, params, entry, queries,
                                       num_slots=3, arrivals=arrivals,
                                       round_chunk=8, device=where)
        out[name] = (ids, dists.view(np.int32), {r.qid: (
            tuple(r.ids), r.admit_round, r.retire_round, r.service_rounds,
            r.truncated, r.stall_rounds) for r in st.results},
            st.quarantined, st.total_rounds)
    np.testing.assert_array_equal(out["captured"][0], out["ref"][0])
    np.testing.assert_array_equal(out["captured"][1], out["ref"][1])
    assert out["captured"][2:] == out["ref"][2:]
    if plan == "corrupt_guarded":
        assert out["ref"][3] > 0


@pytest.fixture(scope="module")
def routed_int():
    """An integer-valued routed index (4 shards of 128, page 16)."""
    from repro_torch.core.router import build_routed_index
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(512, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(24, 16)).astype(np.float32)
    kw = dict(shards=4, page_size=16, r=8, centroids_per_shard=4, seed=0)
    return ({where: build_routed_index(db, **kw, device=where)
             for where in ("cuda", "cpu")}, queries,
            np.cumsum(rng.integers(0, 3, len(queries))))


def test_fuse_topk_quarantines_nonfinite_on_card(dev):
    """fuse_topk on the card (R - 1 launches of the standalone merge)
    == CPU ref mode bit for bit: NaN and inf legs sort last like
    padding, all-INVALID rows come out as (INVALID, BIG_DIST), an entry
    at the engine's BIG_DIST keeps its place before the quarantined
    ones (the merge's filler sorts before the router's BIG_DIST)."""
    from repro_torch.core.backend import KernelBackend
    from repro_torch.core.router import fuse_topk
    leg_d = np.array([[[0.1, 0.2, 0.3, 0.4], [np.nan] * 4, [0.25] * 4],
                      [[0.1, 3.0e38, 0.0, 0.0], [np.inf, 0.0, 0.0, 0.0],
                       [0.0] * 4],
                      [[0.0] * 4] * 3], np.float32)
    leg_i = np.array([[[1, 2, 3, 4], [5, 6, 7, 8], [20, 21, 22, 23]],
                      [[9, 10, -1, -1], [11, -1, -1, -1], [-1] * 4],
                      [[-1] * 4] * 3], np.int32)
    reset_launch_counts()
    got = fuse_topk(leg_d, leg_i, KernelBackend(mode="cuda"), device=dev)
    counts = launch_counts()
    want = fuse_topk(leg_d, leg_i, KernelBackend(mode="ref"), device="cpu")
    assert counts["bitonic_merge"] == 2
    np.testing.assert_array_equal(got[0].cpu().numpy().view(np.int32),
                                  want[0].numpy().view(np.int32))
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    np.testing.assert_array_equal(want[1].numpy()[0], [1, 2, 20, 21])
    assert (want[1].numpy()[2] == -1).all()


def test_router_scores_on_card(dev, routed_int):
    """ShardRouter.shard_scores launches the distance kernel once, its
    query tile S contiguous copies of the (padded) queries: the scores
    equal the CPU's within 1e-6 of the norms' scale; ``route`` sorts
    them with one launch of the standalone sort; the routes equal."""
    built, queries, _ = routed_int
    reset_launch_counts()
    got = built["cuda"].router.shard_scores(queries).cpu().numpy()
    assert launch_counts()["paged_distance"] == 1
    built["cuda"].router.route(queries, 2)
    assert launch_counts()["bitonic_sort"] == 1
    want = built["cpu"].router.shard_scores(queries).numpy()
    scale = (queries * queries).sum(-1)[:, None] + \
        built["cpu"].router.cnorm.numpy().max(-1)[None, :]
    assert (np.abs(got - want) <= 1e-6 * scale).all()
    for r in (1, 2, 4):
        np.testing.assert_array_equal(built["cuda"].router.route(queries, r),
                                      built["cpu"].router.route(queries, r))


@pytest.mark.parametrize("topr,injit,down", [
    (2, True, None), (2, False, None), (4, True, None), (2, True, [1])])
def test_routed_session_cuda_matches_cpu_ref(dev, routed_int, topr, injit,
                                             down):
    """A routed session captured on the card == CPU ref mode on the
    integer routed index: ids, distance bits, every per-query record,
    legs, fused-legs histogram, work per shard. One router distance
    launch, one route sort and R - 1 fusion merges per session; at most
    one capture of the session's chunk program (none when its staged
    queue lands at an earlier session's addresses)."""
    from repro_torch.core.scheduler import routed_stream_search
    built, queries, arrivals = routed_int
    out = {}
    for where, mode in (("cuda", "cuda"), ("cpu", "ref")):
        ri = built[where]
        consts, geom, entry = pack_for_engine(ri.packed, device=where)
        params = EngineParams.lossless(SearchParams(L=16, W=1, k=8), 3, 8,
                                       kernel_mode=mode)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = routed_stream_search(
            consts, geom, params, entry, queries, router=ri.router,
            topr=topr, num_slots=3, arrivals=arrivals, round_chunk=4,
            injit_admit=injit, shard_entries=ri.shard_entries,
            down_shards=down, device=where)
        if where == "cuda":
            counts = launch_counts()
            R = 1 if topr >= 4 else topr
            rounds = 4 * (CACHE.stats.captures + CACHE.stats.replays)
            assert counts["bitonic_merge"] == R - 1
            assert counts["bitonic_sort"] == 1
            assert counts["paged_distance"] == 1 + rounds
            assert CACHE.stats.captures <= 1
        out[where] = (ids, dists.view(np.int32), {r.qid: (
            tuple(r.ids), r.admit_round, r.retire_round, r.service_rounds,
            r.n_dist, r.truncated, r.legs_fused) for r in st.results},
            st.legs, st.legs_fused_hist, st.items_by_shard, st.total_rounds)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["cpu"][1])
    assert out["cuda"][2:] == out["cpu"][2:]


@pytest.mark.parametrize("overload", ["block", "shed"])
def test_ring_session_captures_once_on_card(dev, int_index, overload):
    """The admission ring re-stages its window into the same device
    buffers at every chunk, so the session captures its chunk at most
    once; its records equal CPU ref mode's."""
    packed, queries = int_index
    arrivals = np.random.default_rng(2).integers(0, 6, len(queries))
    out = {}
    for where, mode in ((dev, "cuda"), ("cpu", "ref")):
        params = EngineParams.lossless(SearchParams(L=16, W=1, k=10), 2, 12,
                                       kernel_mode=mode)
        consts, geom, entry = pack_for_engine(packed, device=where)
        CACHE.reset_stats()
        ids, _, st = stream_search(consts, geom, params, entry, queries,
                                   num_slots=2, arrivals=arrivals,
                                   round_chunk=8, ring_capacity=4,
                                   overload=overload, device=where)
        if mode == "cuda":
            assert CACHE.stats.captures <= 1
        out[mode] = (ids, st.shed, {r.qid: (
            tuple(r.ids), r.admit_round, r.retire_round, r.n_dist)
            for r in st.results})
    np.testing.assert_array_equal(out["cuda"][0], out["ref"][0])
    assert out["cuda"][1:] == out["ref"][1:]
    assert (out["ref"][1] > 0) == (overload == "shed")


@pytest.fixture(scope="module")
def tiered_index():
    """tests/test_torch_pagestore.py's integer index (32 pages of 8
    vectors per shard), built by the port."""
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(1024, 32)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(12, 32)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, alpha=1.2, seed=0)
    geo = Geometry(num_shards=4, page_size=8, pages_per_block=2, dim=32)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=2), max_degree=8)
    return packed, queries


@pytest.mark.parametrize("injit,prefetch", [
    (True, True), (True, False), (False, True)])
def test_tiered_session_cuda_matches_cpu_ref(dev, tiered_index, injit,
                                            prefetch):
    """A half-resident tiered session on the card (frames in HBM, the
    cold tier pinned and never on the card, prefetch copies on a side
    stream) equals the same session in ref mode on the CPU: every
    per-query record, the stalls, the store's counters and final
    residency; one capture, one read per chunk, and the frame buffers
    keep their addresses."""
    from repro_torch.core.pagestore import PageStore
    packed, queries = tiered_index
    arrivals = np.random.default_rng(1).integers(0, 10, len(queries))
    out = {}
    for where, mode in ((dev, "cuda"), ("cpu", "ref")):
        consts, geom, entry = pack_for_engine(packed, device=where,
                                              host_pages=True)
        assert not consts["db"].is_cuda and not consts["vnorm"].is_cuda
        NP = consts["db"].shape[1]
        params = EngineParams.lossless(SearchParams(L=8, W=1, k=5), 2, 8,
                                       spec_width=2, kernel_mode=mode,
                                       store_pages=NP)
        ps = PageStore(consts, geom, NP // 2, w_select=1, prefetch=prefetch)
        ptrs = {k: v.data_ptr() for k, v in ps.device_view().items()}
        CACHE.reset_stats()
        ids, dists, st = stream_search(
            consts, geom, params, entry, queries, num_slots=2,
            arrivals=arrivals, round_chunk=2, injit_admit=injit,
            pagestore=ps, device=where)
        assert st.host_syncs == st.host_dispatches
        assert {k: v.data_ptr() for k, v in ps.device_view().items()} == ptrs
        if mode == "cuda":
            assert CACHE.stats.captures == 1
            assert ps.frames.is_cuda and ps.cold_db.is_pinned()
        out[mode] = (ids, dists.view(np.int32), {r.qid: (
            tuple(r.ids), r.admit_round, r.retire_round, r.service_rounds,
            r.n_dist, r.stall_rounds) for r in st.results}, st.stalls,
            ps.counters(), ps.ttab.tolist(), ps.frame_page.tolist())
        assert st.stalls > 0
    np.testing.assert_array_equal(out["cuda"][0], out["ref"][0])
    np.testing.assert_array_equal(out["cuda"][1], out["ref"][1])
    assert out["cuda"][2:] == out["ref"][2:]


def test_frame_installs_equal_cold_tier_on_card(dev, tiered_index):
    """Demand installs (a synchronous copy from the pinned cold tier) and
    a committed prefetch (copied on the side stream, committed at the
    next boundary) leave every resident frame equal to its cold-tier
    page, and the device table equal to the host's."""
    from repro_torch.core.pagestore import PageStore
    packed, _ = tiered_index
    consts, geom, _ = pack_for_engine(packed, device=dev, host_pages=True)
    NP = consts["db"].shape[1]
    ps = PageStore(consts, geom, 4, w_select=1, prefetch_pages=2)
    assert ps.frames.is_cuda and ps.ttab_dev.is_cuda
    score = np.zeros((ps.S, NP))
    score[:, NP - 1] = 5.0
    ps._predict = lambda *a: score
    S = ps.S
    cands = (np.full((S, 1, 4), -1, np.int32), np.zeros((S, 1, 4), bool),
             np.ones((S, 1), bool))
    quiet = np.zeros((S, NP), bool)
    miss = quiet.copy()
    miss[:, 5:8] = True
    ps.boundary(quiet, quiet, *cands)           # stages page NP - 1
    ps.boundary(quiet, miss, *cands)            # commits it; demand 5-7
    torch.cuda.synchronize()
    assert (ps.ttab[:, NP - 1] >= 0).all() and (ps.ttab[:, 5:8] >= 0).all()
    for s in range(S):
        for page in np.flatnonzero(ps.ttab[s] >= 0):
            f = ps.ttab[s, page]
            assert torch.equal(ps.frames[s, f].cpu(), ps.cold_db[s, page])
            assert torch.equal(ps.vnf[s, f].cpu(), ps.cold_vn[s, page])
    np.testing.assert_array_equal(ps.ttab_dev.cpu().numpy(), ps.ttab)


@pytest.mark.parametrize("tiered", [False, True])
def test_live_session_cuda_matches_cpu_ref(dev, tiered):
    """A live session through >= 2 epoch swaps (integer vectors, queries
    and insert payloads) on the card, captured and uncaptured, equals the
    same session in ref mode on the CPU: every per-query record, the live
    counters and the final epoch; the captured one captures its chunk
    once (the live retire's stable sorts run inside the graph)."""
    from repro_torch.core.live import (MutationSchedule, build_live_index,
                                       mutation_schedule)
    from repro_torch.core.pagestore import PageStore
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, (256, 16)).astype(np.float32)
    queries = rng.integers(-8, 9, (12, 16)).astype(np.float32)
    s = mutation_schedule(0.3, 0.1, 60, 16, seed=7)
    vec = np.zeros_like(s.vec)
    near = queries[rng.integers(0, 12, s.num_inserts)]
    vec[s.is_ins] = near + rng.integers(-1, 2, near.shape)
    arrivals = np.sort(rng.integers(0, 60, 12))
    out = {}
    for name, where, mode, capture in (("captured", dev, "cuda", True),
                                       ("uncaptured", dev, "cuda", False),
                                       ("ref", "cpu", "ref", True)):
        live = build_live_index(db, shards=2, page_size=8, r=8, delta_cap=4,
                                seed=3, schedule=MutationSchedule(
                                    t=s.t, is_ins=s.is_ins, vec=vec))
        consts, geom, entry = pack_for_engine(live.ep.packed, device=where,
                                              host_pages=tiered)
        params = EngineParams.lossless(SearchParams(L=16, W=1, k=8), 2, 8,
                                       kernel_mode=mode, delta_cap=4)
        ps = None
        if tiered:
            NP = consts["db"].shape[1]
            ps = PageStore(consts, geom, NP // 2, w_select=1)
            params = dataclasses.replace(params, store_pages=NP)
        CACHE.reset_stats()
        ids, dists, st = stream_search(
            consts, geom, params, entry, queries, num_slots=2,
            arrivals=arrivals, round_chunk=4, live=live, pagestore=ps,
            device=where, capture=capture)
        if name == "captured":
            assert CACHE.stats.captures == 1
        assert st.epoch_swaps >= 2 and st.host_syncs == st.host_dispatches
        out[name] = (ids.tolist(), dists.view(np.int32).tolist(), {
            r.qid: (r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.stall_rounds) for r in st.results},
            st.epoch_swaps, st.delta_hits, st.tombstoned,
            st.swap_stall_rounds, live.ep.ext_ids.tolist(),
            live.ep.tombs.tolist())
    assert out["captured"] == out["ref"]
    assert out["uncaptured"] == out["ref"]


@pytest.fixture(scope="module")
def nccl_mesh(dev):
    """A one-rank NCCL process group in this process (a loopback
    rendezvous on a free port), as an engine mesh; destroyed after the
    module."""
    import datetime
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_engine_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120),
        device_id=torch.device("cuda", torch.cuda.current_device()))
    try:
        yield make_engine_mesh(num=1)
    finally:
        dist.destroy_process_group()


def test_mesh_world1_nccl_matches_cpu_ref(dev, int_index, nccl_mesh):
    """World 1 over NCCL: search_distributed captured on the card (its
    all-to-alls and all-reduces inside the graph) and a mesh stream
    session (in-device admission, chunk 8, spec 4) == CPU ref mode on
    the sim driver, ids, dists and every record; one capture each."""
    from repro_torch.core.engine import search_distributed, shard_consts
    packed, queries = int_index
    S, nq = 4, len(queries)
    qsh = queries.reshape(S, nq // S, -1)
    arrivals = np.random.default_rng(3).integers(0, 20, nq)
    out = {}
    for name, mode, where in (("mesh", "cuda", dev), ("ref", "ref", "cpu")):
        consts, geom, entry = pack_for_engine(packed, device=where)
        if name == "mesh":
            consts = shard_consts(consts, nccl_mesh)
        sp = SearchParams(L=16, W=1, k=10)
        p = EngineParams.lossless(sp, nq // S, 12, kernel_mode=mode)
        CACHE.reset_stats()
        if name == "mesh":
            i, d, st = search_distributed(consts, qsh, *entry, p, geom,
                                          nccl_mesh, device=dev)
            assert CACHE.stats.captures == 1
            assert CACHE.count("search_distributed") == 1
        else:
            i, d, st = search_sim(consts, qsh, *entry, p, geom, device="cpu")
        search = (i.cpu().numpy(), d.cpu().numpy().view(np.int32),
                  {k: v.cpu().numpy() for k, v in st.items()
                   if k != "host_syncs"}, st["host_syncs"])
        p = EngineParams.lossless(sp, 3, 12, spec_width=4, kernel_mode=mode)
        CACHE.reset_stats()
        ids, dists, sst = stream_search(
            consts, geom, p, entry, queries, num_slots=3,
            arrivals=arrivals, round_chunk=8, injit_admit=True, device=where,
            mesh=nccl_mesh if name == "mesh" else None)
        if name == "mesh":
            assert CACHE.stats.captures == 1
            assert sst.host_syncs == sst.host_dispatches
        out[name] = search, (ids, dists.view(np.int32), {
            r.qid: (tuple(r.ids), tuple(r.dists.view(np.int32)),
                    r.admit_round, r.retire_round, r.service_rounds,
                    r.n_dist, r.truncated) for r in sst.results},
            sst.total_rounds, sst.occupancy_trace, sst.host_dispatches)
    (ms, mst), (rs, rst) = out["mesh"], out["ref"]
    np.testing.assert_array_equal(ms[0], rs[0])
    np.testing.assert_array_equal(ms[1], rs[1])
    for k in rs[2]:
        np.testing.assert_array_equal(ms[2][k], rs[2][k], err_msg=k)
    assert ms[3] == rs[3]
    np.testing.assert_array_equal(mst[0], rst[0])
    np.testing.assert_array_equal(mst[1], rst[1])
    assert mst[2:] == rst[2:]


def test_failed_capture_raises(dev):
    """A chunk program that reads the device inside the capture is
    refused: the capture raises, nothing falls back to an eager run."""
    cache = CaptureCache()
    x = torch.arange(8, device=dev, dtype=torch.float32)
    with pytest.raises(RuntimeError, match="capture of the bad chunk"):
        cache.run("bad", lambda a: a * float(a.sum()), (), (x,), 1)
    assert cache.count("bad") == 0
    torch.cuda.synchronize()
    good = cache.run("good", lambda a: a * 2, (), (x,), 1)
    torch.testing.assert_close(good, x * 2)


def _qkv(B, H, Hkv, S, dh, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple((0.5 * torch.randn(shape, generator=g, device=dev)).to(dtype)
                 for shape in ((B, H, S, dh), (B, Hkv, S, dh),
                               (B, Hkv, S, dh)))


@pytest.mark.parametrize("B,H,Hkv,S,dh,dtype,kw", [
    (4, 4, 1, 1024, 256, torch.float32, dict(window=512)),   # gemma3 local
    (4, 4, 1, 1024, 256, torch.float32, dict(window=0)),     # gemma3 global
    (1, 32, 16, 256, 128, torch.float32, dict(softcap=50.0)),
    (2, 4, 1, 512, 256, torch.bfloat16, dict(window=128)),
    (1, 2, 2, 256, 64, torch.float32, dict(causal=False)),
    (2, 4, 2, 96, 16, torch.float32, dict(window=16)),
    (2, 8, 2, 64, 32, torch.bfloat16, dict(softcap=30.0, causal=False)),
    # S not a multiple of the 64-row q block, windows below the block
    (1, 4, 2, 160, 128, torch.float32, dict(window=8)),
    (2, 2, 1, 96, 256, torch.bfloat16, dict(window=40)),
    (1, 4, 4, 224, 64, torch.float32, dict(softcap=20.0, window=48)),
    (1, 2, 1, 32, 32, torch.float32, dict(causal=False)),
])
def test_flash_attention_matches_plain(dev, B, H, Hkv, S, dh, dtype, kw):
    """f32: 2e-5 (online vs one-shot softmax, sums in another order);
    bf16: 3e-2 (the output is rounded to bf16)."""
    q, k, v = _qkv(B, H, Hkv, S, dh, dtype, dev)
    before = FLASH.launches
    out = flash_attention(q, k, v, scale=dh ** -0.5, **kw)
    ref = attention_ref(q, k, v, scale=dh ** -0.5, **kw)
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1 and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def test_attention_op_pads_nonaligned_on_card(dev):
    q, k, v = _qkv(1, 4, 1, 1000, 256, torch.float32, dev, seed=1)
    out = attention_op(q, k, v, scale=1 / 16, causal=True, window=512)
    ref = attention_ref(q, k, v, scale=1 / 16, causal=True, window=512)
    torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)


def test_flash_attention_refused_launch_raises(dev):
    q, k, v = _qkv(1, 2, 2, 64, 64, torch.float32, dev)
    out = torch.empty_like(q)
    before = FLASH.launches
    from repro_torch.kernels.flash_attention.kernel import BWD_KERNEL
    lse = torch.empty((1, 2, 64), device=dev)
    grads = [torch.empty_like(q) for _ in range(3)]
    band = [torch.empty(2 * 2 * 64 * 64, device=dev) for _ in range(2)]
    before_bwd = BWD_KERNEL.launches
    for dh, S in ((48, 64), (64, 0)):     # no such head dim; an empty grid
        with pytest.raises(RuntimeError, match="cudaError"):
            FLASH.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                         out.data_ptr(), None, 1, 2, 2, S, 64, dh, 64, 0.125,
                         1, 0, 0.0, 0)
        with pytest.raises(RuntimeError, match="cudaError"):
            BWD_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), out.data_ptr(), lse.data_ptr(),
                              *(x.data_ptr() for x in grads),
                              *(x.data_ptr() for x in band), 1, 2, 2, S, 64,
                              dh, 64, 0.125, 1, 0, 0.0, 0, 1, 2)
    assert FLASH.launches == before and BWD_KERNEL.launches == before_bwd
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), scale=0.125)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half(), scale=0.125)


def test_flash_cuda_mode_on_cpu_tensors_raises(dev):
    q, k, v = (x.cpu() for x in _qkv(1, 2, 2, 64, 64, torch.float32, dev))
    with pytest.raises(ValueError, match="CUDA"):
        attention_op(q, k, v, scale=0.125, mode="cuda")


def test_prefill_through_the_kernel_matches_ref_mode(dev):
    """Reduced gemma3-1b (6 layers, window 16) on the card: one flash
    launch per layer, logits within 1e-4 of the plain attention's."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import ModelOpts, init_cache, init_params, prefill
    cfg = dataclasses.replace(reduced(get_config("gemma3-1b")), num_layers=6)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=dev)
    out = {}
    for mode in ("auto", "ref"):
        reset_launch_counts()
        cache = init_cache(cfg, 2, 40, dtype=torch.float32, device=dev)
        out[mode], _ = prefill(params, cfg, toks, cache,
                               opts=ModelOpts(attn_mode=mode))
        assert launch_counts()["flash_attention"] == \
            (cfg.num_layers if mode == "auto" else 0)
    torch.testing.assert_close(out["auto"], out["ref"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv_valid,pad", [(1024, 0), (1000, 64),
                                           (700, 32), (33, 0)])
def test_attention_op_cross_with_kv_valid_on_card(dev, kv_valid, pad):
    """Cross-attention's shape through attention_op: non-causal, S 1024
    queries over a kv cache padded by ``pad`` rows, the first
    ``kv_valid`` rows valid; equal to the plain version's within 2e-5."""
    g = torch.Generator(device=dev).manual_seed(kv_valid + pad)
    q = 0.5 * torch.randn((1, 4, 1024, 64), generator=g, device=dev)
    k, v = (0.5 * torch.randn((1, 4, 1024 + pad, 64), generator=g,
                              device=dev) for _ in range(2))
    before = FLASH.launches
    out = attention_op(q, k, v, scale=0.125, causal=False, kv_valid=kv_valid,
                       mode="cuda")
    torch.cuda.synchronize()
    assert FLASH.launches == before + 1
    want = attention_ref(q, k[:, :, :kv_valid], v[:, :, :kv_valid],
                         scale=0.125, causal=False)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(
        attention_op(q, k, v, scale=0.125, causal=False, kv_valid=kv_valid,
                     mode="ref"), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("arch,flash", [("mixtral-8x7b", 4),
                                        ("zamba2-1.2b", 2),
                                        ("seamless-m4t-medium", 10),
                                        ("mamba2-780m", 0)])
def test_family_prefill_on_card_matches_cpu_ref(dev, arch, flash):
    """Reduced moe, hybrid, encdec (and ssm) prefills on the card through
    the kernel (one flash launch per attention: moe per layer, hybrid
    per shared-block application, encdec 2 encoder + 4 self + 4 cross)
    equal the same weights' prefill in ref mode on the CPU within 1e-4,
    the cache too; decode launches no kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import (ModelOpts, decode_step, init_cache,
                                    init_params, prefill)
    import copy
    cfg = reduced(get_config(arch))
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=gen,
                         device=dev)
    fe = (0.05 * torch.randn((2, 40, cfg.d_model), generator=gen,
                             device=dev) if cfg.frontend == "audio" else None)
    runs = {"card": (params, toks, fe, dev, "auto"),
            "cpu": (copy.deepcopy(params).cpu(), toks.cpu(),
                    None if fe is None else fe.cpu(), "cpu", "ref")}
    out = {}
    for where, (p, t, f, device, mode) in runs.items():
        reset_launch_counts()
        cache = init_cache(cfg, 2, 41, enc_len=40, dtype=torch.float32,
                           device=device)
        out[where] = prefill(p, cfg, t, cache,
                             opts=ModelOpts(attn_mode=mode),
                             frontend_embeds=f)
        torch.cuda.synchronize()
        assert launch_counts()["flash_attention"] == \
            (flash if where == "card" else 0)
    torch.testing.assert_close(out["card"][0].cpu(), out["cpu"][0],
                               rtol=1e-4, atol=1e-4)
    for name, got in out["card"][1].items():
        want = out["cpu"][1][name]
        if isinstance(got, torch.Tensor):
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
        elif isinstance(got, list):
            for g, w in zip(got, want):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)
        else:
            assert got == want, name
    reset_launch_counts()
    decode_step(params, cfg, out["card"][1], toks[:, -1:])
    torch.cuda.synchronize()
    assert launch_counts()["flash_attention"] == 0


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_captured_decode_equals_eager_on_card(dev, arch):
    """Reduced gemma3-1b (6 layers: windowed and global) and mamba2-780m
    on the card: the session captures ``decode_step`` as a CUDA graph
    once over a warm-up and a timed generation and replays it once per
    later token, launching no kernel; its greedy tokens and logits equal
    the eager step's (``capture=False``) bit for bit, and the session's
    end drops its entry."""
    from repro_torch.analysis.capture_guard import CaptureGuard
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.serve import greedy_generate, make_step_fns
    from repro_torch.models import ModelOpts, init_params
    cfg = reduced(get_config(arch))
    if arch == "gemma3-1b":
        cfg = dataclasses.replace(cfg, num_layers=6)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen)
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen,
                         device=dev)
    opts, n = ModelOpts(), 8
    before = CACHE.count("decode_step")
    runs = {}
    for capture in (True, False):
        with make_step_fns(cfg, opts, capture=capture) as fns, \
                CaptureGuard() as cg:
            greedy_generate(params, cfg, toks, gen=2, opts=opts,
                            step_fns=fns, cache_len=24 + n)
            replays = CACHE.stats.replays
            reset_launch_counts()
            stats = {}
            out = greedy_generate(params, cfg, toks, gen=n, opts=opts,
                                  step_fns=fns, stats=stats,
                                  keep_logits=True)
            replays = CACHE.stats.replays - replays
            assert launch_counts()["flash_attention"] == \
                (cfg.num_layers if arch == "gemma3-1b" else 0)
        assert cg.count("decode_step") == (1 if capture else 0)
        assert replays == (n - 1 if capture else 0)
        runs[capture] = out, stats["logits"]
    assert torch.equal(runs[True][0], runs[False][0])
    assert torch.equal(runs[True][1], runs[False][1])
    assert CACHE.count("decode_step") == before


def test_serve_cli_on_card(dev, capsys):
    """The serve CLI end to end on the card (reduced gemma3-1b, RAG):
    the retrieval stage launches the search kernels, the prefill one
    flash kernel per layer."""
    import json

    from repro_torch.launch.serve import main
    assert main(["--arch", "gemma3-1b", "--reduced", "--rag", "--batch",
                 "2", "--prompt-len", "40", "--gen", "4"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"] == torch.cuda.get_device_name(dev)
    assert all(res["launches"]["retrieval"][k] > 0 for k in (
        "paged_distance", "bitonic_merge_unsorted"))
    assert res["launches"]["generate"]["flash_attention"] == 4


def test_serve_cli_stream_retrieval_on_card(dev, capsys):
    """``serve --rag --stream-retrieval`` on the card: the retrieval runs
    through the streaming scheduler (the search kernels launch) and
    returns the frozen batch's ids."""
    import json

    from repro_torch.launch.serve import main
    argv = ["--arch", "gemma3-1b", "--reduced", "--rag", "--batch", "4",
            "--prompt-len", "40", "--gen", "3"]
    out = {}
    for stream in (False, True):
        assert main(argv + ["--stream-retrieval"] * stream) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        out[stream] = (lines[0], json.loads(lines[-1]))
    assert out[True][0] == out[False][0]          # the retrieved ids
    res = out[True][1]
    assert res["stream_retrieval"] is True
    assert all(res["launches"]["retrieval"][k] > 0 for k in (
        "paged_distance", "bitonic_merge_unsorted"))


@pytest.mark.parametrize("B,H,Hkv,S,Skv,dh,dtype,kw", [
    (2, 4, 1, 256, 256, 256, torch.float32, dict(window=64)),
    (1, 8, 4, 192, 192, 128, torch.float32, dict(softcap=50.0)),
    (2, 4, 2, 160, 224, 64, torch.float32,
     dict(causal=False, s_orig=200)),
    (1, 4, 1, 128, 128, 16, torch.bfloat16, dict(window=40)),
    (1, 2, 2, 96, 96, 32, torch.float32, dict(window=0)),
    (2, 4, 1, 512, 512, 256, torch.float32, dict(window=0)),
    (2, 4, 2, 160, 224, 64, torch.float32,
     dict(causal=False, s_orig=200, band_budget=1)),
])
def test_flash_attention_bwd_matches_plain(dev, monkeypatch, B, H, Hkv, S,
                                           Skv, dh, dtype, kw):
    """The backward kernels from the forward kernel's out and lse against
    attention_bwd_ref on the same inputs (gradients within 2e-5 x max
    |ref|, bf16 3e-2; the forward's lse within 2e-5), and a second run
    bit for bit (no atomics). Cases: gemma3-like global causal with 4
    heads per kv head (the causal imbalance), and a case whose band
    scratch budget is lowered to 1 byte so that the launch runs one
    (batch, kv head) pair per pass: the same bits as one pass."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_KERNEL, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    kw = dict(kw)
    budget = kw.pop("band_budget", None)
    g = torch.Generator(device=dev).manual_seed(3)
    q, dout = (torch.randn((B, H, S, dh), generator=g, device=dev).to(dtype)
               for _ in range(2))
    k, v = (torch.randn((B, Hkv, Skv, dh), generator=g, device=dev).to(dtype)
            for _ in range(2))
    kw = dict(scale=dh ** -0.5, **kw)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    one_pass = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    if budget is not None:
        monkeypatch.setattr(fk, "BAND_BUDGET", budget)
        assert fk.band_plan(B, H, Hkv, S, causal=kw.get("causal", True),
                            window=kw.get("window", 0),
                            s_orig=kw["s_orig"])[1] == 1
    before = BWD_KERNEL.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    want = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert BWD_KERNEL.launches == before + 2
    assert all(torch.equal(a, b) for a, b in zip(got, one_pass))
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(lse, attention_fwd_ref(q, k, v, **kw)[1],
                               rtol=2e-5, atol=2e-5)
    for a, b, c in zip(got, want, again):
        assert a.dtype == dtype and torch.equal(a, c)
        assert float((a.float() - b.float()).abs().max()) <= \
            tol * float(b.float().abs().max())


def test_train_step_on_card_matches_cpu(dev):
    """Two steps of reduced gemma3-1b through the kernels on the card
    against the same steps on the CPU (plain versions): loss and grad
    norm within 1e-4 relative, parameters within 1e-4, and the launches
    per step (4 layers: 8 forwards with remat, 4 backwards)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params_from_jax, params_to_numpy
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import init_train_state
    cfg = reduced(get_config("gemma3-1b"))
    oc = OptConfig(lr_max=1e-3, warmup=2, decay_steps=10)
    init = params_to_numpy(init_train_state(
        cfg, oc, torch.Generator().manual_seed(0))[0])
    step = make_train_step(cfg, oc, TrainConfig())
    pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=0)
    out = {}
    for device in ("cpu", dev):
        params = params_from_jax(cfg, init, device=device)
        opt = init_opt(params, oc)
        rows = []
        for s in range(2):
            reset_launch_counts()
            params, opt, m = step(params, opt, {
                k: torch.as_tensor(v, device=device)
                for k, v in pipe.batch_at(s).items()})
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         launch_counts()))
        out[str(device)] = (rows, params_to_numpy(params))
    (cpu_rows, cpu_p), (card_rows, card_p) = out["cpu"], out[str(dev)]
    for (cl, cg, _), (gl, gg, launches) in zip(cpu_rows, card_rows):
        assert abs(gl - cl) <= 1e-4 * abs(cl) and abs(gg - cg) <= 1e-4 * cg
        assert {k: n for k, n in launches.items() if n} == {
            "flash_attention": 8, "flash_attention_bwd": 4}
    for a, b in zip(_np_leaves(card_p), _np_leaves(cpu_p)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_dots_train_step_on_card_equals_full(dev):
    """Two steps of reduced gemma3-1b on the card under remat "dots" and
    remat full: the same losses, grad norms and parameters bit for bit
    (the kept products are the values the recompute makes), the same
    flash launches (attention is recomputed under both)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models import params_from_jax, params_to_numpy
    from repro_torch.models.transformer import ModelOpts
    from repro_torch.optim import OptConfig, init_opt
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.trainer import init_train_state
    cfg = reduced(get_config("gemma3-1b"))
    oc = OptConfig(lr_max=1e-3, warmup=2, decay_steps=10)
    init = params_to_numpy(init_train_state(
        cfg, oc, torch.Generator().manual_seed(0))[0])
    pipe = TokenPipeline(cfg.vocab_size, 4, 64, seed=0)
    out = {}
    for remat in ("full", "dots"):
        step = make_train_step(cfg, oc, TrainConfig(),
                               opts=ModelOpts(remat=remat))
        params = params_from_jax(cfg, init, device=dev)
        opt = init_opt(params, oc)
        rows = []
        for s in range(2):
            reset_launch_counts()
            params, opt, m = step(params, opt, {
                k: torch.as_tensor(v, device=dev)
                for k, v in pipe.batch_at(s).items()})
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         launch_counts()))
        out[remat] = (rows, params_to_numpy(params))
    assert out["dots"][0] == out["full"][0]
    for a, b in zip(_np_leaves(out["dots"][1]), _np_leaves(out["full"][1])):
        np.testing.assert_array_equal(a, b)


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    return [tree]
