"""Bitonic sort / top-k / merge and the fused Gather merge: the port's
ops and plain versions vs the reference's Pallas networks (interpret
mode), exactly — ties, non-power-of-two widths and one payload lane
included."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.topk import bitonic_merge as j_merge
from repro.kernels.topk import bitonic_sort as j_sort
from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                      bitonic_sort, bitonic_sort_ref,
                                      merge_sorted_op, merge_unsorted,
                                      merge_unsorted_op, sort_op, topk_op)
from repro_torch.utils import BIG_DIST, ID_SENTINEL


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


@pytest.mark.parametrize("B,M", [(1, 8), (4, 64), (8, 128), (2, 1024),
                                 (16, 32)])
def test_sort_matches_pallas_interpret(B, M):
    rng = np.random.default_rng(B * 1000 + M)
    d = rng.standard_normal((B, M)).astype(np.float32)
    i = rng.integers(0, 2**30, size=(B, M)).astype(np.int32)
    want = j_sort(d, i, interpret=True, block_b=1)
    _eq(bitonic_sort_ref(*_t(d, i)), want)
    _eq(sort_op(*_t(d, i), mode="ref"), want)


@pytest.mark.parametrize("M", [8, 64])
def test_sort_ties_and_payload_lane_match_pallas(M):
    """Dist ties broken by id, and one i32 payload lane carried along."""
    rng = np.random.default_rng(M)
    B = 6
    d = rng.integers(0, 4, (B, M)).astype(np.float32)
    i = np.stack([rng.permutation(M) for _ in range(B)]).astype(np.int32)
    p = rng.integers(0, 9, (B, M)).astype(np.int32)
    want = j_sort(d, i, p, interpret=True, block_b=1)
    _eq(bitonic_sort_ref(*_t(d, i, p)), want)
    _eq(bitonic_sort(*_t(d, i, p)), want)        # CPU tensors: plain version


def test_lexicographic_ties():
    d = np.array([[1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0]], np.float32)
    i = np.array([[7, 6, 5, 4, 3, 2, 1, 0]], np.int32)
    _eq(sort_op(*_t(d, i), mode="ref"),
        j_sort(d, i, interpret=True, block_b=1))


@pytest.mark.parametrize("M", [10, 33, 100])
def test_sort_op_nonpow2_padding(M):
    rng = np.random.default_rng(M)
    d = rng.standard_normal((3, M)).astype(np.float32)
    i = rng.integers(0, 1000, size=(3, M)).astype(np.int32)
    p = rng.integers(0, 2, size=(3, M)).astype(np.int32)
    from repro.kernels.topk import sort_op as j_sort_op
    _eq(sort_op(*_t(d, i, p), mode="ref"),
        j_sort_op(d, i, p, mode="interpret"))


def test_topk_op():
    rng = np.random.default_rng(0)
    d = rng.standard_normal((4, 50)).astype(np.float32)
    i = np.tile(np.arange(50, dtype=np.int32), (4, 1))
    kd, ki = topk_op(*_t(d, i), k=5, mode="ref")
    np.testing.assert_array_equal(kd.numpy(), np.sort(d, axis=1)[:, :5])
    np.testing.assert_array_equal(ki.numpy(), np.argsort(d, axis=1)[:, :5])


def _bitonic_rows(B, M, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((B, M)).astype(np.float32)
    i = rng.permutation(B * M).reshape(B, M).astype(np.int32)
    p = rng.integers(0, 5, (B, M)).astype(np.int32)
    order = np.lexsort((i, d), axis=-1)
    d, i, p = (np.take_along_axis(x, order, -1) for x in (d, i, p))
    h = M // 2
    return tuple(np.concatenate([x[:, :h], x[:, h:][:, ::-1]], axis=1)
                 for x in (d, i, p))


@pytest.mark.parametrize("B,M", [(1, 8), (4, 64), (2, 256)])
def test_merge_network_matches_pallas_interpret(B, M):
    d, i, p = _bitonic_rows(B, M, seed=B * 7 + M)
    want = j_merge(d, i, p, interpret=True, block_b=1)
    _eq(bitonic_merge_ref(*_t(d, i, p)), want)
    _eq(bitonic_merge(*_t(d, i, p)), want)       # CPU tensors: plain version


def test_merge_network_on_non_bitonic_rows_runs_the_same_stages():
    """Not a sort on arbitrary rows — but the same stages as Pallas."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 3, (3, 16)).astype(np.float32)
    i = rng.integers(0, 4, (3, 16)).astype(np.int32)     # exact (d, i) ties
    _eq(bitonic_merge_ref(*_t(d, i)),
        j_merge(d, i, interpret=True, block_b=1))


@pytest.mark.parametrize("la,lb", [(8, 8), (13, 10), (3, 29), (32, 16)])
def test_merge_sorted_op_matches_pallas_and_full_sort(la, lb):
    rng = np.random.default_rng(la * 37 + lb)
    B = 4
    da, ia = jax.lax.sort(
        (jnp.asarray(rng.standard_normal((B, la)), jnp.float32),
         jnp.asarray(rng.permutation(B * la).reshape(B, la), jnp.int32)),
        num_keys=2)
    db, ib = jax.lax.sort(
        (jnp.asarray(rng.standard_normal((B, lb)), jnp.float32),
         jnp.asarray(B * la + rng.permutation(B * lb).reshape(B, lb),
                     jnp.int32)), num_keys=2)
    pa = rng.integers(0, 9, (B, la)).astype(np.int32)
    pb = rng.integers(0, 9, (B, lb)).astype(np.int32)
    from repro.kernels.topk import merge_sorted_op as j_merge_op
    want = j_merge_op(da, ia, db, ib, pay_a=(pa,), pay_b=(pb,),
                      mode="interpret")
    ta, tia, tb, tib, tpa, tpb = _t(da, ia, db, ib, pa, pb)
    got = merge_sorted_op(ta, tia, tb, tib, pay_a=(tpa,), pay_b=(tpb,),
                          mode="ref")
    _eq(got, want)
    full = jax.lax.sort((jnp.concatenate([da, db], 1),
                         jnp.concatenate([ia, ib], 1),
                         jnp.concatenate([pa, pb], 1)), num_keys=2)
    _eq(got, full)


def test_cuda_mode_on_cpu_tensors_raises():
    d, i = _t(np.zeros((2, 8), np.float32), np.zeros((2, 8), np.int32))
    with pytest.raises(ValueError, match="cuda"):
        sort_op(d, i, mode="cuda")
    with pytest.raises(ValueError, match="cuda"):
        merge_sorted_op(d, i, d, i, mode="cuda")
    with pytest.raises(ValueError):
        merge_sorted_op(d, i, d, i, pay_a=(i,), mode="ref")


def _gather_rows(B, la, lb, invalid, seed):
    """Sorted candidates (expanded flags, dist ties) and unsorted
    proposals: some share a candidate's (dist, id) with another payload,
    one duplicates another proposal; ``invalid`` in some/none/all."""
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 4, (B, la)).astype(np.float32)
    ia = rng.permutation(B * la).reshape(B, la).astype(np.int32)
    ea = rng.integers(0, 2, (B, la)).astype(np.int32)
    da, ia, ea = (np.asarray(x) for x in jax.lax.sort(
        (jnp.asarray(da), jnp.asarray(ia), jnp.asarray(ea)), num_keys=2))
    db = rng.integers(0, 4, (B, lb)).astype(np.float32)
    ib = (B * la + rng.permutation(B * lb).reshape(B, lb)).astype(np.int32)
    k = min(la, lb)
    db[:, :k:2], ib[:, :k:2] = da[:, :k:2], ia[:, :k:2]   # ties across A, B
    if lb >= 3:
        db[:, -1], ib[:, -1] = db[:, 1], ib[:, 1]          # a duplicate
    valid = {"some": rng.random((B, lb)) < 0.6,
             "none": np.zeros((B, lb), bool),
             "all": np.ones((B, lb), bool)}[invalid]
    return da, ia, ea.astype(bool), db, ib, valid


@pytest.mark.parametrize("invalid", ["some", "none", "all"])
@pytest.mark.parametrize("la,lb", [(32, 16), (13, 10), (3, 29), (7, 1),
                                   (1, 5)])
def test_merge_unsorted_op_matches_pallas_sort_then_merge(la, lb, invalid):
    """The fused op's plain version vs the reference's sort_op of the
    masked proposals then merge_sorted_op (interpret mode), cut to
    out_w: exact."""
    from repro.kernels.topk import merge_sorted_op as j_merge_op
    from repro.kernels.topk import sort_op as j_sort_op
    B = 5
    da, ia, ea, db, ib, valid = _gather_rows(B, la, lb, invalid,
                                             seed=la * 31 + lb)
    sd, si, sp = j_sort_op(np.where(valid, db, np.float32(BIG_DIST)),
                           np.where(valid, ib, ID_SENTINEL).astype(np.int32),
                           np.zeros((B, lb), np.int32), mode="interpret")
    want = j_merge_op(da, ia, sd, si, pay_a=(ea.astype(np.int32),),
                      pay_b=(sp,), mode="interpret")
    for out_w in (la, la + lb):
        w = (want[0][:, :out_w], want[1][:, :out_w],
             np.asarray(want[2][:, :out_w]) != 0)
        got = merge_unsorted_op(*_t(da, ia, ea, db, ib, valid), out_w,
                                mode="ref")
        assert got[2].dtype == torch.bool
        _eq(got, w)
        _eq(merge_unsorted(*_t(da, ia, ea, db, ib, valid), out_w), w)


def test_merge_unsorted_rejects_bad_widths_and_cuda_on_cpu():
    da, ia, ea, db, ib, valid = _t(*_gather_rows(2, 8, 4, "some", seed=0))
    for out_w in (0, 13):
        with pytest.raises(ValueError, match="out_w"):
            merge_unsorted(da, ia, ea, db, ib, valid, out_w)
    with pytest.raises(ValueError, match="widths"):
        merge_unsorted(da[:, :0], ia[:, :0], ea[:, :0], db, ib, valid, 1)
    big = torch.zeros((2, 2045))
    with pytest.raises(ValueError, match="widths"):
        merge_unsorted(big, big.int(), big.bool(), db, ib, valid, 8)
    with pytest.raises(ValueError, match="cuda"):
        merge_unsorted_op(da, ia, ea, db, ib, valid, 8, mode="cuda")
