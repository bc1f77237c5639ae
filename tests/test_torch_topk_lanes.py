"""Payload lanes in the bitonic sort and merge, on the CPU: any number of
(B, M) lanes, each i32 or f32, permuted alongside the (dist, id) keys
bit for bit (NaN payloads and signed zeros included), in the port's
``ref`` mode against the reference's interpret-mode Pallas kernels
(``sort_op``, ``merge_sorted_op``) and its backend's ``merge_unsorted``
call form; the kernel wrappers' shape-only path (meta tensors) counts
every lane's bytes and refuses another dtype. The card's kernels are
held to the same plain versions in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import KernelBackend as JBackend
from repro.kernels.topk.ops import merge_sorted_op as j_merge_sorted_op
from repro.kernels.topk.ops import sort_op as j_sort_op
from repro_torch.core.backend import KernelBackend
from repro_torch.kernels.build import Kernel
from repro_torch.kernels.topk import bitonic_merge, bitonic_sort
from repro_torch.kernels.topk.kernel import (MAX_LANES, MERGE_KERNEL,
                                             SORT_KERNEL, bitonic_cost)
from repro_torch.kernels.topk.ops import merge_sorted_op, sort_op

MIXES = {0: (), 1: ("f32",), 2: ("i32", "f32"), 3: ("i32", "f32", "i32"),
         4: ("f32", "f32", "i32", "f32")}


def _keys(B, M, seed, ties=False):
    """(dists, ids): equal dists, -0.0 beside 0.0 and inf; with ``ties``
    also exact (dist, id) ties and NaN. A sort is held to the
    reference's network without them (its network is not stable and
    compares NaN as IEEE; the port's sort gives a stable sort's order,
    as the reference's jnp tier); a merge pass compares as the
    reference's does, ties and NaN included."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 5, (B, M)).astype(np.float32)
    if ties:
        i = rng.integers(0, max(1, M // 3), (B, M)).astype(np.int32)
    else:
        i = np.stack([rng.permutation(M) for _ in range(B)]).astype(np.int32)
    if M >= 4:
        d[:, 0], d[:, 1], d[:, 2] = -0.0, 0.0, np.inf
        if ties:
            i[:, 1] = i[:, 0]
            d[:, 3] = np.nan
    return d, i


def _lanes(B, M, kinds, seed):
    """Lanes of random 32-bit words; f32 lanes carry two NaN payloads
    (0x7fc00000 and 0x7fc00123), -0.0 and 0.0."""
    rng = np.random.default_rng(seed + 100)
    out = []
    for kind in kinds:
        w = rng.integers(-2**31, 2**31 - 1, (B, M), dtype=np.int64).astype(
            np.int32)
        if kind == "f32":
            w[:, 0] = np.int32(-2**31)                # -0.0
            w[:, 1] = 0
            w[:, 2 % M] = 0x7fc00000
            w[:, 3 % M] = 0x7fc00123
            w = w.view(np.float32)
        out.append(w)
    return out


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("nl,M", [(n, 20) for n in sorted(MIXES)]
                         + [(3, 16)])
def test_sort_op_lanes_match_the_references_kernel(nl, M):
    """0-4 lanes, mixed i32 / f32, padded (M 20) and not, against the
    reference's Pallas network in interpret mode."""
    d, i = _keys(4, M, seed=M + nl)
    lanes = _lanes(4, M, MIXES[nl], seed=nl)
    want = j_sort_op(jnp.asarray(d), jnp.asarray(i),
                     *(jnp.asarray(x) for x in lanes), mode="interpret")
    got = sort_op(torch.as_tensor(d), torch.as_tensor(i),
                  *(torch.as_tensor(x) for x in lanes), mode="ref")
    _eq(got, want)


@pytest.mark.parametrize("nl,la,lb", [(0, 16, 16), (2, 16, 16),
                                      (4, 16, 16), (2, 13, 7)])
def test_merge_sorted_op_lanes_match_the_references_kernel(nl, la, lb):
    da, ia = _keys(4, la, seed=la, ties=True)
    db, ib = _keys(4, lb, seed=lb + 7, ties=True)
    sa = j_sort_op(jnp.asarray(da), jnp.asarray(ia), mode="ref")
    sb = j_sort_op(jnp.asarray(db), jnp.asarray(ib), mode="ref")
    pa = _lanes(4, la, MIXES[nl], seed=1)
    pb = _lanes(4, lb, MIXES[nl], seed=2)
    want = j_merge_sorted_op(*sa, *sb, pay_a=tuple(map(jnp.asarray, pa)),
                             pay_b=tuple(map(jnp.asarray, pb)),
                             mode="interpret")
    t = (torch.as_tensor(np.array(x)) for x in (*sa, *sb))
    got = merge_sorted_op(*t, pay_a=tuple(map(torch.as_tensor, pa)),
                          pay_b=tuple(map(torch.as_tensor, pb)), mode="ref")
    _eq(got, want)


@pytest.mark.parametrize("mode,ref_mode", [("ref", "interpret"),
                                           ("torch", "jnp")])
def test_backend_merge_unsorted_call_form(mode, ref_mode):
    """The reference's ``merge_unsorted(d_a, i_a, d_b, i_b, pay_a,
    pay_b)`` with three lanes (a bool, an i32 and an f32 one) on the
    port's KernelBackend: in ``ref`` mode a sort of B and one merge
    pass, as the reference's interpret mode runs it; in ``torch`` mode
    one sort of the concatenation, as the reference's jnp mode."""
    B, la, lb = 4, 16, 12
    da, ia = _keys(B, la, seed=3)
    sa = JBackend(mode="jnp").sort_pairs(jnp.asarray(da), jnp.asarray(ia))
    db, ib = _keys(B, lb, seed=4)
    ib = ib + 100                     # no (dist, id) tie across the sides
    pa = [np.arange(B * la).reshape(B, la) % 2 == 0,
          *_lanes(B, la, ("i32", "f32"), seed=5)]
    pb = [np.zeros((B, lb), bool), *_lanes(B, lb, ("i32", "f32"), seed=6)]
    want = JBackend(mode=ref_mode).merge_unsorted(
        *sa, jnp.asarray(db), jnp.asarray(ib),
        pay_a=tuple(map(jnp.asarray, pa)), pay_b=tuple(map(jnp.asarray, pb)))
    got = KernelBackend(mode=mode).merge_unsorted(
        *(torch.as_tensor(np.array(x)) for x in (*sa, db, ib)),
        pay_a=tuple(map(torch.as_tensor, pa)),
        pay_b=tuple(map(torch.as_tensor, pb)))
    assert got[2].dtype == torch.bool
    _eq(got, want)


def test_meta_launch_counts_every_lane():
    """The shape-only path: each lane's bytes in the declared cost (one
    launch per MAX_LANES lanes, as on the card), the outputs' shapes and
    dtypes, no launch counted; a lane of another
    dtype raises with the contract in the message."""
    seen = []

    def listen(kernel, cost):
        seen.append((kernel.name, cost()))
    B, M = 8, 32
    d = torch.empty((B, M), device="meta")
    i = torch.empty((B, M), dtype=torch.int32, device="meta")
    lanes = (i, d, i)
    for k in (SORT_KERNEL, MERGE_KERNEL):
        k.listeners.append(listen)
    try:
        before = (SORT_KERNEL.launches, MERGE_KERNEL.launches)
        out = bitonic_sort(d, i, *lanes)
        bitonic_merge(d, i)
        # past MAX_LANES lanes: one launch per MAX_LANES, keys in each
        bitonic_sort(d, i, *([i] * (MAX_LANES + 1)))
        assert (SORT_KERNEL.launches, MERGE_KERNEL.launches) == before
    finally:
        for k in (SORT_KERNEL, MERGE_KERNEL):
            k.listeners.remove(listen)
    assert [x.dtype for x in out] == [torch.float32, torch.int32,
                                      torch.int32, torch.float32,
                                      torch.int32]
    assert seen == [("bitonic_sort", bitonic_cost(B, M, 3, False)),
                    ("bitonic_merge", bitonic_cost(B, M, 0, True)),
                    ("bitonic_sort", bitonic_cost(B, M, MAX_LANES, False)),
                    ("bitonic_sort", bitonic_cost(B, M, 1, False))]
    # 4 bytes an entry per key and lane, read and written once
    assert bitonic_cost(B, M, 3, False)[1] == 2 * B * M * 4 * 5
    assert bitonic_cost(B, M, 0, True)[0] == B * (M // 2) * 5
    with pytest.raises(TypeError, match="i32/f32"):
        bitonic_sort(d, i, i.long())
    with pytest.raises(TypeError, match="i32/f32"):
        bitonic_merge(d, i, d, d.half())
    assert isinstance(SORT_KERNEL, Kernel)
