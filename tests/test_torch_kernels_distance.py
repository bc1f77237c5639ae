"""SiN distance: the port's plain version and ops vs the reference's Pallas
kernel (interpret mode) and ops, on the same numpy inputs.

Tolerances: rtol 0 on integer-valued inputs (every f32 step is exact);
rtol 1e-6 on real inputs, where torch's and XLA's products sum over d in
different orders (bf16 operands too: their upcast to f32 is exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.distance import coalesced_distance_op as j_coalesced
from repro.kernels.distance import paged_distances as j_paged
from repro.kernels.distance.ref import paged_distances_ref as j_paged_ref
from repro.kernels.distance.ops import coalesce_num_tiles as j_num_tiles
from repro.kernels.distance.ops import pad_tiles as j_pad_tiles
from repro_torch.kernels.distance import (coalesce_num_tiles,
                                          coalesced_distance_op,
                                          paged_distance_op, paged_distances,
                                          paged_distances_ref, pad_tiles)

SWEEP = [(1, 8, 128, 128, 2), (4, 16, 256, 128, 8), (7, 8, 128, 64, 3),
         (16, 32, 128, 256, 4)]


def _mk(T, QB, P, d, NP, integer, seed=0):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-8, 9, (T, QB, d)).astype(np.float32)
        db = rng.integers(-8, 9, (NP, P, d)).astype(np.float32)
    else:
        q = rng.standard_normal((T, QB, d)).astype(np.float32)
        db = rng.standard_normal((NP, P, d)).astype(np.float32)
    qq = (q ** 2).sum(-1)
    vnorm = (db ** 2).sum(-1)
    pid = rng.integers(0, NP, size=T).astype(np.int32)
    return pid, q, qq, db, vnorm


def _t(args):
    return tuple(torch.as_tensor(a) for a in args)


@pytest.mark.parametrize("T,QB,P,d,NP", SWEEP)
@pytest.mark.parametrize("integer", [True, False])
def test_plain_version_matches_pallas_interpret(T, QB, P, d, NP, integer):
    args = _mk(T, QB, P, d, NP, integer)
    want = np.asarray(j_paged(*args, interpret=True))
    got = paged_distances_ref(*_t(args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0 if integer else 1e-6,
                               atol=0)


def test_wrapper_on_cpu_tensors_is_the_plain_version():
    args = _t(_mk(5, 8, 64, 32, 3, integer=False, seed=2))
    assert torch.equal(paged_distances(*args), paged_distances_ref(*args))


def test_op_modes_and_no_cpu_fallback_for_cuda_mode():
    args = _t(_mk(3, 4, 16, 8, 2, integer=True, seed=1))
    ref = paged_distances_ref(*args)
    for mode in ("auto", "ref"):
        assert torch.equal(paged_distance_op(*args, mode=mode), ref)
    with pytest.raises(ValueError, match="cuda"):
        paged_distance_op(*args, mode="cuda")
    with pytest.raises(ValueError):
        paged_distance_op(*args, mode="pallas")


def test_repeated_pages_match_reference():
    """Sorted, repeated page ids (the dynamic-scheduling fast path)."""
    pid, q, qq, db, vn = _mk(8, 8, 64, 32, 4, integer=True)
    pid = np.array([0, 0, 0, 1, 1, 2, 3, 3], np.int32)
    want = np.asarray(j_paged(pid, q, qq, db, vn, interpret=True))
    np.testing.assert_array_equal(
        paged_distances_ref(*_t((pid, q, qq, db, vn))).numpy(), want)


def _item_case(npages=6, p=8, d=16, items=40, seed=1, ragged=False):
    rng = np.random.default_rng(seed)
    db = rng.integers(-8, 9, (npages, p, d)).astype(np.float32)
    vnorm = (db * db).sum(-1)
    if ragged:
        counts = [1, 3, items - 4 - 7, 7]
        pp = np.repeat(np.arange(4, dtype=np.int32), counts)
        rng.shuffle(pp)
    else:
        pp = rng.integers(0, npages, items).astype(np.int32)
    sl = rng.integers(0, p, items).astype(np.int32)
    mask = rng.integers(0, 2, items).astype(bool)
    qv = rng.integers(-8, 9, (items, d)).astype(np.float32)
    return pp, sl, mask, qv, (qv * qv).sum(-1), db, vnorm


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("qb", [1, 3, 8])
def test_coalesced_matches_reference(qb, ragged):
    args = _item_case(ragged=ragged, seed=7)
    want = np.asarray(j_coalesced(*args, qb=qb, mode="interpret"))
    got = coalesced_distance_op(*_t(args), qb=qb, mode="ref").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qb", [1, 3, 8])
def test_coalesced_all_masked_tiles(qb):
    pp, sl, mask, qv, qq, db, vn = _item_case(seed=11)
    mask = np.zeros_like(mask)
    want = np.asarray(j_coalesced(pp, sl, mask, qv, qq, db, vn, qb=qb,
                                  mode="ref"))
    got = coalesced_distance_op(*_t((pp, sl, mask, qv, qq, db, vn)), qb=qb,
                                mode="ref").numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == np.float32(3.0e38)).all()


@pytest.mark.parametrize("qb", [1, 3, 8])
def test_coalesced_shard_axis_equals_per_shard_calls(qb):
    """The engine's one-launch form: a leading shard axis tiles each shard
    exactly as a call of its own would."""
    cases = [_item_case(seed=s, ragged=bool(s % 2)) for s in range(3)]
    stacked = _t(tuple(np.stack(x) for x in zip(*cases)))
    got = coalesced_distance_op(*stacked, qb=qb, mode="ref")
    for s, case in enumerate(cases):
        want = np.asarray(j_coalesced(*case, qb=qb, mode="ref"))
        np.testing.assert_array_equal(got[s].numpy(), want)


def test_coalesce_num_tiles_matches_reference():
    for items in (1, 7, 40, 256, 1024, 4096):
        for npages in (1, 2, 6, 32, 64, 100):
            for qb in (1, 3, 8, 16):
                assert coalesce_num_tiles(items, npages, qb) == \
                    j_num_tiles(items, npages, qb)
    assert coalesce_num_tiles(4096, 32, 8) == 540        # main path, per shard
    with pytest.raises(ValueError):
        coalesce_num_tiles(8, 2, 0)


def test_pad_tiles_roundtrip():
    q = torch.ones((3, 5, 16))
    qq = torch.full((3, 5), 2.0)
    q2, qq2 = pad_tiles(q, qq, qb=8)
    assert q2.shape == (3, 8, 16) and qq2.shape == (3, 8)
    assert torch.equal(q2[:, :5], q) and torch.equal(qq2[:, :5], qq)
    assert float(q2[:, 5:].abs().sum()) == 0.0
    q3, qq3 = pad_tiles(q2, qq2, qb=8)
    assert q3 is q2 and qq3 is qq2
    jq, _ = j_pad_tiles(jnp.ones((3, 5, 16)), jnp.full((3, 5), 2.0), qb=8)
    np.testing.assert_array_equal(np.asarray(jq), q2.numpy())


# ---------------------------------------------------------------------------
# bf16 operands: queries and store may each be bf16 (f32 accumulate)
# ---------------------------------------------------------------------------
def _bf16_pair(args, qt, dt):
    """The same inputs with q and db cast to bf16 where asked, for both
    packages: (jax arrays, torch tensors); qq and vnorm are the upcast
    operands' self dots, f32."""
    pid, q, _, db, _ = args
    jq = jnp.asarray(q, jnp.bfloat16) if qt == "bf16" else jnp.asarray(q)
    jdb = jnp.asarray(db, jnp.bfloat16) if dt == "bf16" else jnp.asarray(db)
    qq = (np.asarray(jq, np.float32) ** 2).sum(-1)
    vn = (np.asarray(jdb, np.float32) ** 2).sum(-1)
    tq, tdb = torch.as_tensor(q), torch.as_tensor(db)
    tq = tq.bfloat16() if qt == "bf16" else tq
    tdb = tdb.bfloat16() if dt == "bf16" else tdb
    return ((jnp.asarray(pid), jq, jnp.asarray(qq), jdb, jnp.asarray(vn)),
            (torch.as_tensor(pid), tq, torch.as_tensor(qq), tdb,
             torch.as_tensor(vn)))


@pytest.mark.parametrize("T,QB,P,d,NP", SWEEP[:3] + [(9, 4, 32, 36, 5)])
@pytest.mark.parametrize("qt,dt", [("bf16", "f32"), ("f32", "bf16"),
                                   ("bf16", "bf16")])
@pytest.mark.parametrize("integer", [True, False])
def test_bf16_plain_version_matches_reference(T, QB, P, d, NP, qt, dt,
                                              integer):
    """bf16 q and/or db: the plain version equals the reference's
    ``paged_distances_ref`` and its Pallas kernel (interpret mode) — bit
    for bit on integer inputs, within 1e-6 relative on real ones (the
    products sum over d in different orders) — and equals the f32 plain
    version on the upcast operands exactly."""
    jargs, targs = _bf16_pair(_mk(T, QB, P, d, NP, integer, seed=3), qt, dt)
    got = paged_distances_ref(*targs).numpy()
    rtol = 0 if integer else 1e-6
    np.testing.assert_allclose(got, np.asarray(j_paged_ref(*jargs)),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(
        got, np.asarray(j_paged(*jargs, interpret=True)), rtol=rtol, atol=0)
    up = (targs[0], targs[1].float(), targs[2], targs[3].float(), targs[4])
    assert torch.equal(paged_distances_ref(*up), paged_distances_ref(*targs))
    assert torch.equal(paged_distances(*targs), paged_distances_ref(*targs))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("qb", [1, 3, 8])
def test_coalesced_bf16_queries_match_reference(qb, ragged):
    """``payload_bf16``'s shape of the call: bf16 per-assignment query
    payloads against the f32 store; the tiles keep bf16 and the result
    equals the reference's (integer inputs, exact in bf16)."""
    pp, sl, mask, qv, qq, db, vn = _item_case(ragged=ragged, seed=13)
    want = np.asarray(j_coalesced(pp, sl, mask, jnp.asarray(qv, jnp.bfloat16),
                                  qq, db, vn, qb=qb, mode="interpret"))
    targs = _t((pp, sl, mask, qv, qq, db, vn))
    tq = targs[3].bfloat16()
    got = coalesced_distance_op(*targs[:3], tq, *targs[4:], qb=qb,
                                mode="ref").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, coalesced_distance_op(*targs, qb=qb, mode="ref").numpy())
