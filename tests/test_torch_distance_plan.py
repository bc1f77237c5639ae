"""The paged distance kernel's launch plan, on the CPU.

``launch_plan`` sizes a launch from the shapes and the SM count alone.
``_block_steps`` below models the kernel's walk of one block's slice of
the T * QB query rows by the rules ``csrc/paged_distance.cu`` states
(slices, steps of one page id, sub-pages, d-chunks), so that a plan can
be checked against them here; the kernel itself is held to its plain
version on the card (tests/test_torch_cuda.py). Over a sweep of shapes,
page sizes, widths and SM counts: the slices cut the rows into one piece
each, every (query row, page row, column) falls in exactly one step, a
block's shared memory stays within what one block may have, the plan
reads no page id, and the router's and tiered sessions' shapes fill a
wave of a 132-SM card with every thread of a step holding work. Pure
Python and numpy.
"""
import numpy as np
import pytest

from repro_torch.kernels.distance import kernel as dk

TIMING_SHAPES = {           # (T, QB, P, d) of the timing rows
    "search": (4320, 8, 64, 128),
    "router": (8, 2048, 8, 128),
    "tiered": (456, 8, 64, 128),
}
ROWS = [(4320, 8), (8, 2048), (456, 8), (8, 1000), (37, 3), (1, 1)]


def _block_steps(plan, page_ids, T, QB, P, d, NP, b):
    """Block ``b``'s steps by the kernel's rules: (first flat query row,
    rows, page (the id clamped into the NP pages), first page row, first
    column, page staged for the step). The slice is rows
    [M b / B, M (b + 1) / B) of M = T * QB; a step's rows share one tile
    page id and number at most ``plan.mq``; each such run of rows is
    walked by sub-page of pt * npg rows, then by d-chunk; a page is
    staged again unless the last step held it whole."""
    rows = T * QB
    begin, end = rows * b // plan.blocks, rows * (b + 1) // plan.blocks
    pr, whole = plan.pt * plan.npg, plan.dc >= d
    nsub = -(-P // pr)
    steps, staged, m0 = [], None, begin
    while m0 < end:
        stop, t = min(m0 + plan.mq, end), m0 // QB
        pid = int(page_ids[t])
        while (t + 1) * QB < stop and int(page_ids[t + 1]) == pid:
            t += 1
        n = min(stop, (t + 1) * QB) - m0
        pid = min(max(pid, 0), NP - 1)
        for sub in range(nsub):
            for c0 in range(0, d, plan.dc):
                new = not (whole and nsub == 1 and staged == pid)
                steps.append((m0, n, pid, sub * pr, c0, new))
                staged = pid
        m0 += n
    return steps


def _ids(T, NP, seed, order):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, NP + 1, T)     # out-of-range ids clamp
    return np.sort(ids) if order == "sorted" else ids


def _check_walk(T, QB, P, d, sms, NP, ids):
    plan = dk.launch_plan(T, QB, P, d, sms)
    pr = plan.pt * plan.npg
    assert plan.smem == dk.smem_bytes(plan.pt, plan.npg, plan.mq, plan.dc)
    assert plan.smem <= 227 * 1024
    assert plan.qt in dk.QTS and plan.npg * (dk.THREADS // plan.npg) == \
        dk.THREADS and plan.mq == (dk.THREADS // plan.npg) * plan.qt
    assert plan.pt in (2, 4)
    if plan.pt == 4:           # one page slot: the page whole, one sub-page
        assert plan.dc >= d and pr >= P
    assert 1 <= plan.blocks <= dk.MAX_BLOCKS_PER_SM * sms
    assert plan.dc >= d or plan.dc % 8 == 0    # raw bf16 slots: 16 bytes
    nsub, nchunk = -(-P // pr), -(-d // plan.dc)
    rows = T * QB
    cover = np.zeros((rows, nsub, nchunk), np.int32)
    bounds = []
    for b in range(plan.blocks):
        steps = _block_steps(plan, ids, T, QB, P, d, NP, b)
        lo = rows * b // plan.blocks
        bounds.append((lo, rows * (b + 1) // plan.blocks))
        staged = None
        for m0, n, pid, p0, c0, new in steps:
            assert 1 <= n <= plan.mq and p0 % pr == 0 and c0 % plan.dc == 0
            tiles = ids[m0 // QB:(m0 + n - 1) // QB + 1]
            assert len(set(tiles.tolist())) == 1      # one page id a step
            assert pid == min(max(int(tiles[0]), 0), NP - 1)
            assert new or staged == (pid, p0, c0)
            staged = (pid, p0, c0)
            cover[m0:m0 + n, p0 // pr, c0 // plan.dc] += 1
    assert bounds[0][0] == 0 and bounds[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    np.testing.assert_array_equal(cover, 1)
    return plan


@pytest.mark.parametrize("P", [8, 17, 64, 128, 256])
@pytest.mark.parametrize("d", [30, 128, 784])
def test_plan_covers_every_row_once(P, d):
    """Every query row meets every page row and column in exactly one
    step, on sorted ids (the dispatcher's order), unsorted ones and out
    of range ones, on a card of 132 SMs and of one."""
    for T, QB in ROWS:
        if T * QB * P * d > 4320 * 8 * 64 * 128 and (T, QB) != (1, 1):
            T = max(1, T // 8)     # the widest cases: fewer rows
        for sms in (132, 1):
            for order in ("sorted", "random"):
                _check_walk(T, QB, P, d, sms, 7, _ids(T, 7, T + P, order))


@pytest.mark.parametrize("name", sorted(TIMING_SHAPES))
def test_timing_shapes_fill_the_card(name):
    """At the paths' shapes (page-sorted ids) the plan covers every row
    once; the router's and tiered sessions' shapes launch at least one
    block per SM of a 132-SM card, where the design before this one
    launched 8 and 57; the search's, with many rows a block, takes the
    wide tiles; most threads hold query rows in a typical step."""
    T, QB, P, d = TIMING_SHAPES[name]
    NP = {"search": 256, "router": 8, "tiered": 192}[name]
    ids = (np.arange(T) if name == "router"
           else np.sort(np.random.default_rng(5).integers(0, NP, T)))
    plan = _check_walk(T, QB, P, d, 132, NP, ids)
    assert plan.dc >= d                       # d staged whole
    if name != "search":
        assert plan.blocks >= 132
    else:                  # a full step a block: 4 x 4 tiles, one page slot
        assert (plan.pt, plan.qt) == (4, 4)
    nqg = dk.THREADS // plan.npg
    busy = []
    for b in range(plan.blocks):
        for _, n, *_ in _block_steps(plan, ids, T, QB, P, d, NP, b):
            groups = min(n, nqg)              # query groups with a row
            rows = min(P, plan.pt * plan.npg)   # page rows of a step
            busy.append(groups * min(plan.npg, -(-rows // plan.pt))
                        / dk.THREADS)
    assert np.median(busy) >= 0.9


def test_plan_depends_on_shapes_only():
    """The plan is a function of (T, QB, P, d, SMs): the same for any
    page ids (it takes none), the same on every call, and one wave of
    blocks at most."""
    for T, QB, P, d in TIMING_SHAPES.values():
        plan = dk.launch_plan(T, QB, P, d, 132)
        dk.launch_plan.cache_clear()
        assert dk.launch_plan(T, QB, P, d, 132) == plan
        per_sm = min(dk.MAX_BLOCKS_PER_SM,
                     dk.SMEM_SM // (plan.smem + 1024))
        assert plan.blocks == min(per_sm * 132, T * QB)
        for ids in (np.zeros(T, int), np.arange(T)[::-1].copy()):
            walked = sum(n for b in range(plan.blocks)
                         for _, n, *_ in _block_steps(plan, ids, T, QB, P,
                                                        d, max(T, 1), b))
            assert walked == T * QB
