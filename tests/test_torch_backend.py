"""KernelBackend: the port's ``ref`` and ``torch`` modes vs the reference
backend's ``jnp`` mode, bit for bit on integer-valued vectors, plus the
port's mode rules (auto resolves per device; cuda never falls back)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.backend import KernelBackend as JBackend
from repro.core.backend import paged_view as j_paged_view
from repro_torch.core.backend import MODES, KernelBackend, paged_view
from repro_torch.utils import BIG_DIST, ID_SENTINEL

PORT_MODES = ("ref", "torch")
JNP = JBackend(mode="jnp")


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.dtype == torch.bool) == (w.dtype == jnp.bool_)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _t(*xs):
    return tuple(torch.as_tensor(np.array(x)) for x in xs)


def test_modes_and_validation():
    assert MODES == ("auto", "cuda", "ref", "torch")
    for m in MODES:
        KernelBackend(mode=m)
    for bad in ("pallas", "interpret", "jnp", "triton"):
        with pytest.raises(ValueError):
            KernelBackend(mode=bad)
    with pytest.raises(ValueError):
        KernelBackend(coalesce_qb=-1)
    assert KernelBackend(mode="torch").inline
    assert not KernelBackend(mode="auto").inline


def test_cuda_mode_on_cpu_tensors_raises():
    pp, sl, mask, qv, qq, db, vn = _t(*_item_case())
    with pytest.raises(ValueError, match="cuda"):
        KernelBackend(mode="cuda").item_distances(pp, sl, mask, qv, qq, db, vn)
    d, i = _t(np.zeros((2, 4), np.float32), np.zeros((2, 4), np.int32))
    with pytest.raises(ValueError, match="cuda"):
        KernelBackend(mode="cuda").sort_pairs(d, i)


@pytest.mark.parametrize("mode", PORT_MODES)
def test_sort_pairs_payload_lane_matches_jnp(mode):
    rng = np.random.default_rng(0)
    d = rng.integers(0, 6, (5, 24)).astype(np.float32)
    i = rng.permutation(5 * 24).reshape(5, 24).astype(np.int32)
    e = rng.integers(0, 2, (5, 24)).astype(bool)
    _eq(KernelBackend(mode=mode).sort_pairs(*_t(d, i, e)),
        JNP.sort_pairs(jnp.asarray(d), jnp.asarray(i), jnp.asarray(e)))


def _item_case(npages=6, p=8, d=16, items=40, seed=1, ragged=False):
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, (npages, p, d)).astype(np.float32)
    vnorm = (db * db).sum(-1)
    if ragged:
        pp = np.repeat(np.arange(4, dtype=np.int32), [1, 3, items - 11, 7])
        rng.shuffle(pp)
    else:
        pp = rng.integers(0, npages, items).astype(np.int32)
    sl = rng.integers(0, p, items).astype(np.int32)
    mask = rng.integers(0, 2, items).astype(bool)
    qv = rng.integers(-8, 9, (items, d)).astype(np.float32)
    return pp, sl, mask, qv, (qv * qv).sum(-1), db, vnorm


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("qb", [0, 1, 3, 8, 64])
def test_item_distances_match_jnp(mode, qb, ragged):
    case = _item_case(ragged=ragged, seed=7)
    want = np.asarray(JNP.item_distances(*case))
    got = KernelBackend(mode=mode, coalesce_qb=qb).item_distances(*_t(*case))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", PORT_MODES)
def test_item_distances_shard_axis(mode):
    cases = [_item_case(seed=s) for s in range(4)]
    stacked = _t(*(np.stack(x) for x in zip(*cases)))
    got = KernelBackend(mode=mode, coalesce_qb=3).item_distances(*stacked)
    for s, case in enumerate(cases):
        np.testing.assert_array_equal(got[s].numpy(),
                                      np.asarray(JNP.item_distances(*case)))


def test_item_distances_all_masked():
    pp, sl, _, qv, qq, db, vn = _item_case(seed=11)
    mask = np.zeros(pp.shape, bool)
    for mode in PORT_MODES:
        out = KernelBackend(mode=mode, coalesce_qb=4).item_distances(
            *_t(pp, sl, mask, qv, qq, db, vn))
        assert (out == torch.tensor(BIG_DIST)).all()


def test_grid_steps_and_coalesce_activation_match_reference():
    for items, npages in [(40, 6), (4096, 32), (10, 100), (1024, 64)]:
        for qb in (0, 1, 8, 16):
            a, b = KernelBackend(coalesce_qb=qb), JBackend(coalesce_qb=qb)
            assert a.coalesce_active(items, npages) == \
                b.coalesce_active(items, npages)
            assert a.distance_grid_steps(items, npages) == \
                b.distance_grid_steps(items, npages)


def _sorted_rows(B, m, seed, id0=0):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 6, (B, m)).astype(np.float32)
    i = (id0 + rng.permutation(B * m).reshape(B, m)).astype(np.int32)
    return tuple(np.array(x) for x in jax.lax.sort(
        (jnp.asarray(d), jnp.asarray(i)), num_keys=2))


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("la,lb", [(8, 8), (11, 7), (5, 16), (1, 1), (32, 16)])
def test_merge_pairs_matches_jnp(mode, la, lb):
    B = 5
    da, ia = _sorted_rows(B, la, la * 100 + lb)
    db, ib = _sorted_rows(B, lb, lb, id0=B * la)
    ea = np.random.default_rng(la).integers(0, 2, (B, la)).astype(bool)
    eb = np.zeros((B, lb), bool)
    want = JNP.merge_pairs(*(jnp.asarray(x) for x in (da, ia, db, ib)),
                           pay_a=(jnp.asarray(ea),), pay_b=(jnp.asarray(eb),))
    ta, tia, tb, tib, tea, teb = _t(da, ia, db, ib, ea, eb)
    got = KernelBackend(mode=mode).merge_pairs(ta, tia, tb, tib,
                                               pay_a=(tea,), pay_b=(teb,))
    assert got[2].dtype == torch.bool
    _eq(got, want)


@pytest.mark.parametrize("mode", PORT_MODES)
@pytest.mark.parametrize("lb", [16, 20])
def test_merge_unsorted_matches_jnp(mode, lb):
    """The Gather stage's real shape: sorted candidate list (with
    sentinel padding) + unsorted proposals (with masked entries). The
    reference's call form (pre-masked proposals, an all-False payload
    lane on B) on both sides; then the port's fused ``merge_gather``,
    which masks the invalid proposals itself, cut to the candidate width
    and to the full merged width."""
    B, la = 6, 32
    da, ia = _sorted_rows(B, la, 3)
    da[:, 20:], ia[:, 20:] = np.float32(BIG_DIST), ID_SENTINEL
    rng = np.random.default_rng(lb)
    db = rng.integers(0, 6, (B, lb)).astype(np.float32)
    ib = (B * la + rng.permutation(B * lb).reshape(B, lb)).astype(np.int32)
    vb = np.ones((B, lb), bool)
    vb[:, ::5] = False
    ea = rng.integers(0, 2, (B, la)).astype(bool)
    ea[:, 20:] = False
    eb = np.zeros((B, lb), bool)
    db_m = np.where(vb, db, np.float32(BIG_DIST))
    ib_m = np.where(vb, ib, ID_SENTINEL).astype(np.int32)
    want = JNP.merge_unsorted(*(jnp.asarray(x) for x in (da, ia, db_m, ib_m)),
                              pay_a=(jnp.asarray(ea),),
                              pay_b=(jnp.asarray(eb),))
    ta, tia, tdb, tib, tea, teb = _t(da, ia, db_m, ib_m, ea, eb)
    got = KernelBackend(mode=mode).merge_unsorted(
        ta, tia, tdb, tib, pay_a=(tea,), pay_b=(teb,))
    assert got[2].dtype == torch.bool
    _eq(got, want)
    for out_w in (la, la + lb):
        got = KernelBackend(mode=mode).merge_gather(
            *_t(da, ia, ea, db, ib, vb), out_w)
        assert got[2].dtype == torch.bool
        _eq(got, tuple(w[:, :out_w] for w in want))


def test_paged_view_matches_reference():
    db = np.arange(7 * 3, dtype=np.float32).reshape(7, 3)
    vnorm = (db * db).sum(-1)
    pg, vg = paged_view(*_t(db, vnorm), page_size=4)
    jpg, jvg = j_paged_view(jnp.asarray(db), jnp.asarray(vnorm), 4)
    _eq((pg, vg), (jpg, jvg))
    assert pg.shape == (2, 4, 3)
