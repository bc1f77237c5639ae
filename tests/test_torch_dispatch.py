"""The Allocator discipline (core/dispatch.py) on seeded cases, in place
of the hypothesis-only tests/test_dispatch_property.py (hypothesis is
not installed): scatter/gather round trips, dense first-come ranks,
masks against ``dispatch_stats``, drops exactly the overflow — each
against the reference's functions on the same numpy inputs — and
``build_page_tiles`` equal to the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dispatch import bucket_mask as j_bucket_mask
from repro.core.dispatch import build_page_tiles as j_build_page_tiles
from repro.core.dispatch import compute_ranks as j_compute_ranks
from repro.core.dispatch import dispatch_stats as j_dispatch_stats
from repro.core.dispatch import gather_from_buckets as j_gather
from repro.core.dispatch import scatter_to_buckets as j_scatter
from repro_torch.core.dispatch import (bucket_mask, build_page_tiles,
                                       compute_ranks, dispatch_stats,
                                       gather_from_buckets,
                                       scatter_to_buckets)

SEEDS = range(24)


def _case(seed):
    """The property test's strategy, drawn from a numpy seed: m in
    [1, 40], s in [1, 6], capacity in [1, 12]."""
    rng = np.random.default_rng(seed)
    m, s, cap = (int(rng.integers(1, 41)), int(rng.integers(1, 7)),
                 int(rng.integers(1, 13)))
    dest = rng.integers(0, s, m).astype(np.int32)
    valid = rng.integers(0, 2, m).astype(bool)
    return dest, valid, s, cap


def _t(*a):
    return tuple(torch.as_tensor(x) for x in a)


@pytest.mark.parametrize("seed", SEEDS)
def test_roundtrip_identity(seed):
    """gather(scatter(x)) == x for every item that fits its bucket; the
    buckets equal the reference's."""
    dest, valid, s, cap = _case(seed)
    m = dest.shape[0]
    payload = np.arange(1, m + 1, dtype=np.float32)[:, None] * [1.0, 2.0]
    payload = payload.astype(np.float32)
    d, v, p = _t(dest, valid, payload)
    rank, _ = compute_ranks(d, v, s)
    buckets = scatter_to_buckets(d, rank, v, p, s, cap)
    back = gather_from_buckets(buckets, d, rank, v, cap).numpy()
    ok = valid & (rank.numpy() < cap)
    np.testing.assert_array_equal(back[ok], payload[ok])
    np.testing.assert_array_equal(back[~ok], 0.0)
    jrank, _ = j_compute_ranks(jnp.asarray(dest), jnp.asarray(valid), s)
    jb = j_scatter(jnp.asarray(dest), jrank, jnp.asarray(valid),
                   jnp.asarray(payload), s, cap)
    np.testing.assert_array_equal(buckets.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(
        back, np.asarray(j_gather(jb, jnp.asarray(dest), jrank,
                                  jnp.asarray(valid), cap)))


@pytest.mark.parametrize("seed", SEEDS)
def test_ranks_are_dense_and_fcfs(seed):
    dest, valid, s, cap = _case(seed)
    rank, counts = compute_ranks(*_t(dest, valid), s)
    rank = rank.numpy()
    for d in range(s):
        idx = np.where((dest == d) & valid)[0]
        np.testing.assert_array_equal(rank[idx], np.arange(idx.size))
    assert int(counts.sum()) == int(valid.sum())
    jrank, jcounts = j_compute_ranks(jnp.asarray(dest), jnp.asarray(valid), s)
    np.testing.assert_array_equal(rank, np.asarray(jrank))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))


@pytest.mark.parametrize("seed", SEEDS)
def test_mask_matches_accepted(seed):
    dest, valid, s, cap = _case(seed)
    d, v = _t(dest, valid)
    rank, _ = compute_ranks(d, v, s)
    mask = bucket_mask(d, rank, v, s, cap).numpy()
    sent, dropped, load = dispatch_stats(d, rank, v, s, cap)
    assert mask.sum() == int(sent)
    assert int(sent) + int(dropped) == int(valid.sum())
    np.testing.assert_array_equal(load.numpy(), mask.sum(axis=1))
    assert mask.sum(axis=1).max(initial=0) <= cap
    jd, jv = jnp.asarray(dest), jnp.asarray(valid)
    jrank, _ = j_compute_ranks(jd, jv, s)
    np.testing.assert_array_equal(mask, np.asarray(
        j_bucket_mask(jd, jrank, jv, s, cap)))
    for a, b in zip((sent, dropped, load),
                    j_dispatch_stats(jd, jrank, jv, s, cap)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", SEEDS)
def test_drops_are_exactly_overflow(seed):
    """Dropped items are precisely those with rank >= capacity — the
    bounded-LUN-queue semantics (first come, first served)."""
    dest, valid, s, cap = _case(seed)
    d, v = _t(dest, valid)
    rank, _ = compute_ranks(d, v, s)
    _, dropped, _ = dispatch_stats(d, rank, v, s, cap)
    assert int(dropped) == int((valid & (rank.numpy() >= cap)).sum())


def test_dispatch_stats_batched_rows():
    """A leading batch axis (the engine's source shard) gives each row's
    own stats."""
    cases = [_case(s) for s in range(3)]
    s, cap = 4, 3
    rng = np.random.default_rng(5)
    dest = rng.integers(0, s, (3, 20)).astype(np.int32)
    valid = rng.integers(0, 2, (3, 20)).astype(bool)
    d, v = _t(dest, valid)
    rank, _ = compute_ranks(d, v, s)
    sent, dropped, load = dispatch_stats(d, rank, v, s, cap)
    for r in range(3):
        one = dispatch_stats(d[r], rank[r], v[r], s, cap)
        assert int(sent[r]) == int(one[0]) and \
            int(dropped[r]) == int(one[1])
        assert torch.equal(load[r], one[2])
    assert len(cases) == 3


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("qb", [1, 3, 8])
def test_build_page_tiles_equals_reference(seed, qb):
    rng = np.random.default_rng(seed)
    pages = rng.integers(0, 9, int(rng.integers(1, 60))).astype(np.int32)
    got = build_page_tiles(pages, None, qb)
    want = j_build_page_tiles(pages, None, qb)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tile_page, rows, ok = got
    # every row lands once, on a tile of its own page
    assert sorted(rows[ok].tolist()) == list(range(len(pages)))
    np.testing.assert_array_equal(pages[rows[ok]],
                                  np.repeat(tile_page, ok.sum(1)))
