"""The op-stream cost model (repro_torch/launch/opanalysis.py), the twin of
tests/test_hlo_analysis.py: a matmul's operations, loops counted as they
run (a Python loop stands in for a scan), bytes that grow with the loop,
a predicated chunk of K rounds counted as K rounds with its dead ones
(the twin of the dynamic-while case, which the reference counts once
with a warning), and the distance's plain version against the closed
form its kernel declares. ``test_parse_tuple_types_with_index_comments``
has no twin: nothing is parsed from text here, the op stream is recorded
as it runs. Shapes are unique to this file, so no other test pre-built
a chunk-program entry it reads."""
import numpy as np
import pytest
import torch

from repro_torch.launch.opanalysis import OpStream, analyze, summarize

D = 96
DOT_FLOPS = 2 * D ** 3


@pytest.fixture(scope="module")
def mats():
    g = torch.Generator().manual_seed(0)
    return (torch.randn((D, D), generator=g),
            torch.randn((D, D), generator=g))


def test_single_matmul(mats):
    r = analyze(torch.mm, *mats)
    assert abs(r["flops"] - DOT_FLOPS) / DOT_FLOPS < 0.01
    assert r["by_op"]["aten::mm"]["count"] == 1
    assert r["hbm_bytes"] == 3 * D * D * 4          # two reads, one write


def test_loop_multiplies(mats):
    a, w = mats

    def f(c):
        for _ in range(10):
            c = c @ w
        return c
    r = analyze(f, a)
    assert abs(r["flops"] - 10 * DOT_FLOPS) / DOT_FLOPS < 0.1


def test_nested_loop_multiplies(mats):
    a, w = mats

    def f(c):
        for _ in range(2):
            for _ in range(5):
                c = c @ w
        return c
    r = analyze(f, a)
    assert abs(r["flops"] - 10 * DOT_FLOPS) / DOT_FLOPS < 0.1


def test_bytes_grow_with_loop(mats):
    a, w = mats

    def f10(c):
        for _ in range(10):
            c = c @ w
        return c
    b1 = analyze(torch.mm, a, w)["hbm_bytes"]
    b10 = analyze(f10, a)["hbm_bytes"]
    assert b10 > 5 * b1


def test_predicated_chunk_counts_every_round(mats):
    """A chunk of K predicated rounds whose condition dies after the
    first counts K rounds, dead ones included, as the card runs them;
    without a recorder the CPU stops after the first dead round."""
    from repro_torch.core.engine import _predicated
    a, w = mats
    K, calls = 6, []

    def body(c):
        calls.append(1)
        return c[0] @ w, c[1] + 1

    def cond(c):
        return c[1] < 1
    carry = (a, torch.zeros((), dtype=torch.int32))
    r = analyze(_predicated, carry, cond, body, K)
    assert abs(r["flops"] - K * DOT_FLOPS) / DOT_FLOPS < 0.1
    assert len(calls) == K
    out = r["result"]
    assert int(out[1]) == 1                     # one live round, then dead
    torch.testing.assert_close(out[0], a @ w, rtol=0, atol=0)
    calls.clear()
    _predicated(carry, cond, body, K)
    assert len(calls) == 2


def test_every_round_is_the_only_switch_of_the_early_exit(mats):
    """The CPU's early exit of a predicated chunk is switched off by
    ``engine.every_round()`` alone: another dispatch mode leaves it on,
    and the result is bit-equal either way."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.core.engine import _predicated, every_round
    a, w = mats
    K, calls = 5, []

    class Passthrough(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            return func(*args, **(kwargs or {}))

    def body(c):
        calls.append(1)
        return c[0] @ w, c[1] + 1

    def cond(c):
        return c[1] < 2
    carry = (a, torch.zeros((), dtype=torch.int32))
    outs = {}
    for name, ctx in (("plain", None), ("other_mode", Passthrough),
                      ("every_round", every_round)):
        calls.clear()
        if ctx is None:
            outs[name] = _predicated(carry, cond, body, K)
        else:
            with ctx():
                outs[name] = _predicated(carry, cond, body, K)
        assert len(calls) == (K if name == "every_round" else 3), name
        assert int(outs[name][1]) == 2
        torch.testing.assert_close(outs[name][0], outs["plain"][0],
                                   rtol=0, atol=0)
    with every_round(), every_round():           # nests
        pass
    calls.clear()
    _predicated(carry, cond, body, K)
    assert len(calls) == 3                       # closed again


def test_engine_chunk_counts_k_rounds():
    """The engine's own chunk program, uncaptured, at a budget of one
    round: the recorder sees its K rounds (one distance product each)."""
    from repro_torch.analysis.op_audit import TINY, build_tiny_problem
    from repro_torch.core.engine import engine_run_chunk
    p = build_tiny_problem("cpu")
    r = analyze(engine_run_chunk, p["consts"], p["state"], p["queries"],
                p["spec_state"], p["spec_cfg"], 1, False, p["params"],
                p["geom"], TINY["K"], dynamic=True, capture=False)
    assert r["by_op"]["aten::bmm"]["count"] == TINY["K"]
    assert int(r["result"][2]) == 1             # the steps run: one


@pytest.mark.parametrize("T,QB,P,d,NP", [(7, 3, 5, 11, 4), (13, 8, 16, 24, 9)])
def test_paged_distance_ref_equals_closed_form(T, QB, P, d, NP):
    """ref-mode paged_distances (the plain version the CPU runs) does the
    operations its kernel declares from the shapes: the products and
    the norms' three per output; it moves at least the declared bytes."""
    from repro_torch.kernels.distance import kernel as dk
    g = torch.Generator().manual_seed(T)
    pid = torch.randint(0, NP, (T,), generator=g, dtype=torch.int32)
    q = torch.randn((T, QB, d), generator=g)
    db = torch.randn((NP, P, d), generator=g)
    r = analyze(dk.paged_distances, pid, q, (q * q).sum(-1), db,
                (db * db).sum(-1))
    ops, nbytes = dk.cost(T, QB, P, d, NP)
    assert r["flops"] == ops
    assert r["hbm_bytes"] >= nbytes


def test_kernel_launches_add_their_declared_cost():
    """A launch reports to the kernel's listeners with its wrapper's
    cost: the stream adds it under the kernel's name (on the CPU no
    kernel launches, so the listener is called as a launch calls it)."""
    from repro_torch.kernels.distance import kernel as dk
    from repro_torch.kernels.topk.kernel import (MERGE_UNSORTED_KERNEL,
                                                 merge_unsorted_cost)
    with OpStream() as stream:
        assert stream._launched in dk.KERNEL.listeners
        for fn in dk.KERNEL.listeners:
            fn(dk.KERNEL, lambda: dk.cost(4320, 8, 64, 128, 2048, pages=1))
        for fn in MERGE_UNSORTED_KERNEL.listeners:
            fn(MERGE_UNSORTED_KERNEL, lambda: merge_unsorted_cost(
                256, 32, 16, 32))
    assert dk.KERNEL.listeners == []
    rep = summarize(stream.records)
    ops, nbytes = dk.cost(4320, 8, 64, 128, 2048, pages=1)
    assert rep["kernels"]["paged_distance"] == {
        "launches": 1, "flops": ops, "bytes": nbytes}
    m_ops, m_bytes = merge_unsorted_cost(256, 32, 16, 32)
    # 16 proposals: sort network 8 * 4 * 5 / 2; merge over 64: 32 * 6
    assert m_ops == 256 * (8 * 10 + 32 * 6)
    assert rep["flops"] == ops + m_ops
    assert rep["hbm_bytes"] == nbytes + m_bytes


def test_views_and_allocations_move_nothing():
    x = torch.arange(24.0).reshape(4, 6)
    r = analyze(lambda: (x.t(), x[:, :2], x.view(-1), torch.empty(8)))
    assert r["hbm_bytes"] == 0 and r["flops"] == 0
    # a reshape that must copy moves the data once (the clone); the view
    # it hands back (aten::_unsafe_view) moves nothing
    r = analyze(lambda: x.t().reshape(-1))
    assert r["by_op"]["aten::_unsafe_view"]["bytes"] == 0
    assert r["hbm_bytes"] == 2 * 24 * 4


def test_gather_and_in_place_update_move_only_what_they_touch():
    """A gather reads what it produces (plus its indices); index_copy_
    writes only the update (plus its indices), not the whole buffer."""
    big = torch.zeros((1000, 16))
    idx = torch.tensor([3, 7], dtype=torch.int64)
    upd = torch.ones((2, 16))
    g = analyze(torch.index_select, big, 0, idx)
    assert g["hbm_bytes"] == 2 * 2 * 16 * 4 + 2 * 8
    u = analyze(lambda: big.index_copy_(0, idx, upd))
    assert u["hbm_bytes"] == 2 * 2 * 16 * 4 + 2 * 8
    np.testing.assert_array_equal(big[3].numpy(), np.ones(16))
