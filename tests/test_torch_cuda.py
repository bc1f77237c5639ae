"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (and nvcc, to build the kernels at
first use): they carry the ``cuda`` marker and skip without a card. Run
them on a GPU machine with ``python -m pytest -q -m cuda
tests/test_torch_cuda.py``. This file imports only the port.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import EngineParams, pack_for_engine, search_sim
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.distance import (paged_distances,
                                          paged_distances_ref)
from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                      bitonic_sort, bitonic_sort_ref,
                                      merge_sorted_op, sort_op)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _dist_case(T, QB, P, d, NP, dev, integer, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        q = torch.randint(-8, 9, (T, QB, d), generator=g, device=dev).float()
        db = torch.randint(-8, 9, (NP, P, d), generator=g, device=dev).float()
    else:
        q = torch.randn((T, QB, d), generator=g, device=dev)
        db = torch.randn((NP, P, d), generator=g, device=dev)
    pid = torch.randint(0, NP, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    return pid, q, (q * q).sum(-1), db, (db * db).sum(-1)


@pytest.mark.parametrize("T,QB,P,d,NP", [
    (1, 8, 128, 128, 2), (4, 16, 256, 128, 8), (7, 8, 128, 64, 3),
    (16, 32, 128, 256, 4), (540, 8, 64, 128, 32), (9, 1, 64, 784, 5)])
@pytest.mark.parametrize("integer", [True, False])
def test_paged_distance_matches_plain(dev, T, QB, P, d, NP, integer):
    args = _dist_case(T, QB, P, d, NP, dev, integer)
    out = paged_distances(*args)
    ref = paged_distances_ref(*args)
    torch.cuda.synchronize()
    if integer:   # every f32 step exact: any evaluation order agrees
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:         # summation order (FMA chain vs batched product)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_paged_distance_rejects_bf16_and_cpu_mix(dev):
    pid, q, qq, db, vn = _dist_case(2, 8, 64, 32, 2, dev, True)
    with pytest.raises(TypeError):
        paged_distances(pid, q, qq, db.bfloat16(), vn)
    with pytest.raises(ValueError):
        paged_distances(pid.cpu(), q, qq, db, vn)


def _rows(B, M, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 6, (B, M), generator=g, device=dev).float()  # ties
    i = torch.argsort(torch.rand((B, M), generator=g, device=dev), -1)
    p = torch.randint(0, 2, (B, M), generator=g, device=dev)
    return d, i.int(), p.int()


@pytest.mark.parametrize("B,M", [(256, 16), (256, 64), (3, 1), (5, 2),
                                 (2, 2048), (300, 32)])
def test_bitonic_sort_matches_plain(dev, B, M):
    d, i, p = _rows(B, M, dev, seed=M)
    for got, want in ((bitonic_sort(d, i, p), bitonic_sort_ref(d, i, p)),
                      (bitonic_sort(d, i), bitonic_sort_ref(d, i))):
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


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


def test_sort_rejects_bad_widths(dev):
    d, i, p = _rows(2, 4096, dev, seed=0)
    with pytest.raises(ValueError):
        bitonic_sort(d, i, p)
    with pytest.raises(ValueError):
        bitonic_sort(d[:, :24], i[:, :24])
    with pytest.raises(ValueError):
        sort_op(d[:, :16], i[:, :16], p[:, :16], p[:, :16], mode="cuda")


def test_search_sim_cuda_matches_cpu_ref(dev):
    rng = np.random.default_rng(0)
    n, dim, S = 512, 16, 4
    db = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(32, dim)).astype(np.float32)
    adj, medoid = build_vamana(db, r=8, seed=0)
    geo = Geometry(num_shards=S, page_size=16, pages_per_block=2, dim=dim)
    packed = pack_index(LUNCSR.from_adjacency(db, adj, geo, entry=medoid,
                                              pref_width=4), max_degree=8)
    qsh = queries.reshape(S, -1, dim)
    out = {}
    for mode, where in (("cuda", dev), ("ref", "cpu")):
        params = EngineParams.lossless(SearchParams(L=16, W=2, k=10),
                                       qsh.shape[1], 8, spec_width=4,
                                       kernel_mode=mode)
        consts, geom, entry = pack_for_engine(packed, device=where)
        reset_launch_counts()
        ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                    device=where)
        out[mode] = (ids.cpu(), dists.cpu(),
                     {k: v.cpu() for k, v in st.items() if k != "host_syncs"})
        if mode == "cuda":
            assert all(v > 0 for v in launch_counts().values())
    for a, b in zip(out["cuda"][:2], out["ref"][:2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    for k, v in out["ref"][2].items():
        torch.testing.assert_close(out["cuda"][2][k], v, rtol=0, atol=0)
