#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line (a phase that fails
raises, so the script exits nonzero and prints no result line):

  1. device  — the card's name and power limit (as nvidia-smi prints
               them), torch and CUDA versions; TF32 is switched off.
  2. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels — hold each kernel against its plain PyTorch version on the
               card: the SiN distance at the main path's tile shapes and
               on a 1M-vector (512 MiB) paged store, exact on integer-
               valued inputs and within RTOL_REAL on real ones; the
               bitonic sort and merge exactly, with a payload lane, ties
               and duplicated (dist, id, payload) entries.
  4. int     — search_sim on an integer-valued index: cuda mode on the
               card equals ref mode on the CPU bit for bit.
  5. main    — the sift-1b stand-in at the CLI defaults (n=16384, d=128,
               8 shards, page 64, degree 16, L=32, W=1, k=10, 256
               queries): host build, then search_sim in auto mode (the
               kernels). Launch counts are zeroed just before and read
               just after; every kernel must have launched, and recall@k
               must be within 0.01 of the reference package's value.
  6. timing  — each kernel at the main path's shapes: its time, its
               bound, the plain version's time and one library call's.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Exits nonzero when no CUDA device is
present, and when the repository's package is missing.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# recall@k of `python -m repro.launch.search --kernel-mode jnp` (the
# reference package, CLI defaults: sift-1b stand-in, n=16384) on the CPU
REFERENCE_RECALL = 0.6719
RECALL_TOL = 0.01
# real-valued inputs: the kernel's sequential FMA chain over d and the
# plain version's batched product sum in different orders
RTOL_REAL = 1e-5
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def event_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean time of ``fn()`` between CUDA events over ``iters`` back-to-
    back calls. When the host enqueues more slowly than the card runs,
    this is the host's launch rate, not the device time."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernel_us(prof) -> dict:
    """{kernel name: (total device us, count)} from a torch.profiler run."""
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if us > 0:
            out[e.key] = (float(us), int(e.count))
    return out


def device_ms(fn, iters: int = 50, warmup: int = 5):
    """(mean device-kernel ms per call of ``fn()``, method): the sum of
    the card's kernel times per call, from torch.profiler; CUDA events
    when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total_us = sum(us for us, _ in device_kernel_us(prof).values())
    if total_us > 0:
        return total_us / 1e3 / iters, "profiler"
    return event_ms(fn, iters, warmup), "events"


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` through
    HBM and doing ``ops`` f32 operations outside the tensor cores."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


# the CLI defaults: the shape of the main path
SHARDS, N, DIM, PAGE, DEGREE, L, W, K, NQ, QB = (8, 16384, 128, 64, 16, 32,
                                                 1, 10, 256, 8)


def main_path_tiles():
    """(T, QB, P, d, pages) of the phase-B distance launch on the main
    path: every shard's lossless bucket (S * Qs * W * R assignments)
    coalesced into per-page tiles, all shards in one launch."""
    from repro_torch.core.backend import KernelBackend
    from repro_torch.core.luncsr import Geometry
    nps = Geometry(num_shards=SHARDS, page_size=PAGE,
                   pages_per_block=4).pages_per_shard(N)
    items = SHARDS * (NQ // SHARDS) * W * DEGREE
    be = KernelBackend(coalesce_qb=QB)
    qb = QB if be.coalesce_active(items, nps) else 1
    return (SHARDS * be.distance_grid_steps(items, nps), qb, PAGE, DIM,
            SHARDS * nps)


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def distance_case(T, QB, P, d, NP, dev, integer: bool, seed: int):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        q = torch.randint(-8, 9, (T, QB, d), generator=g, device=dev).float()
        db = torch.randint(-8, 9, (NP, P, d), generator=g, device=dev).float()
    else:
        q = torch.randn((T, QB, d), generator=g, device=dev)
        db = torch.randn((NP, P, d), generator=g, device=dev)
    pid = torch.sort(torch.randint(0, NP, (T,), generator=g, device=dev,
                                   dtype=torch.int32)).values
    return pid, q, (q * q).sum(-1), db, (db * db).sum(-1)


def check_distance(shapes: dict, dev) -> float:
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    worst = 0.0
    for label, (T, QB, P, d, NP) in shapes.items():
        for integer in (True, False):
            args = distance_case(T, QB, P, d, NP, dev, integer, seed=T + NP)
            out = paged_distances(*args)
            ref = paged_distances_ref(*args)
            err = (out - ref).abs()
            max_abs = float(err.max())
            max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
            if integer and max_abs != 0.0:
                raise AssertionError(f"paged_distance {label}: integer-valued "
                                     f"inputs differ by {max_abs}")
            if not integer and max_rel > RTOL_REAL:
                raise AssertionError(f"paged_distance {label}: relative error "
                                     f"{max_rel} > {RTOL_REAL}")
            worst = max(worst, max_abs)
            emit({"phase": "kernels", "kernel": "paged_distance",
                  "case": label, "T": T, "QB": QB, "P": P, "d": d, "NP": NP,
                  "store_mib": NP * P * d * 4 / 2**20,
                  "inputs": "integer" if integer else "real",
                  "max_abs_err": max_abs, "max_rel_err": max_rel,
                  "tolerance": "exact" if integer else f"rtol {RTOL_REAL}"})
            del args, out, ref, err
    return worst


def sort_rows(B, M, dev, seed: int):
    """Rows with dist ties, distinct ids, and a few duplicated
    (dist, id, payload) entries; one i32 payload lane."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    d = torch.randint(0, 8, (B, M), generator=g, device=dev).float()
    i = torch.argsort(torch.rand((B, M), generator=g, device=dev), -1).int()
    p = torch.randint(0, 2, (B, M), generator=g, device=dev).int()
    if M >= 4:
        for x in (d, i, p):
            x[:, M - 1] = x[:, 0]
    return d, i, p


def check_topk(dev) -> float:
    import torch
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref)
    for kernel, plain, label in ((bitonic_sort, bitonic_sort_ref,
                                  "bitonic_sort"),
                                 (bitonic_merge, bitonic_merge_ref,
                                  "bitonic_merge")):
        for B, M in ((256, 16), (256, 64), (7, 2048), (5, 1)):
            d, i, p = sort_rows(B, M, dev, seed=M)
            if kernel is bitonic_merge:     # make each row bitonic
                d, i, p = bitonic_sort_ref(d, i, p)
                h = M // 2
                d, i, p = (torch.cat([x[:, :h], x[:, h:].flip(1)], 1)
                           for x in (d, i, p))
            for lanes in ((p,), ()):
                got = kernel(d, i, *lanes)
                want = plain(d, i, *lanes)
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(f"{label} B={B} M={M}: kernel "
                                             f"differs from plain version")
            emit({"phase": "kernels", "kernel": label, "B": B, "M": M,
                  "payload_lanes": [1, 0], "max_abs_err": 0.0,
                  "tolerance": "exact"})
    return 0.0


# ---------------------------------------------------------------------------
# Phases 4 and 5: the main path
# ---------------------------------------------------------------------------
def integer_main_path(dev) -> None:
    import numpy as np
    import torch
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.launch.search import build_index

    rng = np.random.default_rng(0)
    n, dim, shards, nq = 2048, 32, 8, 256
    db = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, dim)).astype(np.float32)
    t0 = time.perf_counter()
    _, packed = build_index(db, shards=shards, page_size=64, r=16)
    build_s = time.perf_counter() - t0
    qsh = queries.reshape(shards, nq // shards, dim)
    out = {}
    for mode, where in (("cuda", dev), ("ref", torch.device("cpu"))):
        params = EngineParams.lossless(SearchParams(L=32, W=1, k=10),
                                       nq // shards, 16, kernel_mode=mode)
        consts, geom, entry = pack_for_engine(packed, device=where)
        ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                    device=where)
        out[mode] = {"ids": ids.cpu(), "dists": dists.cpu(),
                     **{k: v.cpu() for k, v in st.items()
                        if k != "host_syncs"}}
    for key, want in out["ref"].items():
        if not torch.equal(out["cuda"][key], want):
            raise AssertionError(f"integer main path: cuda-mode {key} "
                                 f"differs from CPU ref mode")
    emit({"phase": "int", "n": n, "d": dim, "shards": shards, "queries": nq,
          "host_build_s": round(build_s, 2),
          "rounds": int(out["ref"]["total_rounds"].max()),
          "bit_identical": sorted(out["ref"])})


def real_main_path(dev):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import build_index, dataset, run_search

    ds = dataset("sift-1b")
    assert (ds.n, ds.dim) == (N, DIM)
    db0 = ds.materialize()
    queries = ds.queries(NQ, seed=1)
    t0 = time.perf_counter()
    db, packed = build_index(db0, shards=SHARDS, page_size=PAGE, r=DEGREE)
    build_s = time.perf_counter() - t0
    cfg = dict(shards=SHARDS, L=L, W=W, k=K, spec=0, kernel_mode="auto",
               coalesce_qb=QB, device=dev)
    run_search(packed, db, queries, **cfg)             # warm-up
    reset_launch_counts()
    res = run_search(packed, db, queries, **cfg)
    launches = launch_counts()
    res.update(dataset=ds.name, host_build_s=round(build_s, 2),
               launches=launches,
               launches_per_round={k: v / res["rounds"]
                                   for k, v in launches.items()})
    emit({"phase": "main", **res})
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{launches}")
    if not math.isfinite(res["recall@k"]) or \
            abs(res["recall@k"] - REFERENCE_RECALL) > RECALL_TOL:
        raise AssertionError(f"recall@k {res['recall@k']} not within "
                             f"{RECALL_TOL} of {REFERENCE_RECALL}")
    if not math.isfinite(res["mean_dists_per_query"]):
        raise AssertionError("non-finite distance count")
    profile_main_path(packed, queries, res["search_s"], dev)
    return db, packed, launches


def profile_main_path(packed, queries, wall_s: float, dev) -> None:
    """One more search_sim call under torch.profiler (device activity
    only): the card's kernel time by name, and its busy share of the
    unprofiled call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.ref_search import SearchParams

    consts, geom, entry = pack_for_engine(packed, device=dev)
    params = EngineParams.lossless(SearchParams(L=L, W=W, k=K),
                                   NQ // SHARDS, DEGREE, coalesce_qb=QB)
    qsh = torch.as_tensor(queries.reshape(SHARDS, NQ // SHARDS, -1),
                          device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, st = search_sim(consts, qsh, *entry, params, geom, device=dev)
        torch.cuda.synchronize()
    kern = device_kernel_us(prof)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    ours = {"paged_distance": "paged_distance_kernel",
            "bitonic_sort|merge": "bitonic_kernel"}
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
    emit({"phase": "profile", "wall_ms_unprofiled": wall_s * 1e3,
          "device_busy_ms": busy_ms,
          "device_idle_share": (1.0 - busy_ms / (wall_s * 1e3)
                                if busy_ms else None),
          "device_ops": sum(c for _, c in kern.values()),
          "rounds": int(st["total_rounds"].max()),
          "ported_kernels_ms": {k: sum(us for name, (us, _) in kern.items()
                                       if v in name) / 1e3
                                for k, v in ours.items()},
          "top": [{"name": name[:80], "ms": us / 1e3, "count": c}
                  for name, (us, c) in top]})


# ---------------------------------------------------------------------------
# Phase 6: timing at the main path's shapes
# ---------------------------------------------------------------------------
def time_kernels(packed, launches, errs, dev) -> list:
    import torch
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref)

    S, nps, P, d = packed.db.shape
    T, qb, _, _, _ = main_path_tiles()
    g = torch.Generator(device=dev).manual_seed(7)
    store = torch.as_tensor(packed.db, device=dev).reshape(S * nps, P, d)
    vnorm = torch.as_tensor(packed.vnorm, device=dev).reshape(S * nps, P)
    pid = torch.sort(torch.randint(0, S * nps, (T,), generator=g,
                                   device=dev, dtype=torch.int32)).values
    q = store[torch.randint(0, S * nps, (T,), generator=g, device=dev),
              :qb].contiguous()                       # real vectors as queries
    qq = (q * q).sum(-1)
    dargs = (pid, q, qq, store, vnorm)
    pages = store[pid.long()]
    base = qq[:, :, None] + vnorm[pid.long()][:, None, :]
    uniq = int(torch.unique(pid).numel())
    nbytes = (pid.numel() * 4 + q.numel() * 4 + qq.numel() * 4
              + uniq * P * (d + 1) * 4 + T * qb * P * 4)
    rows = []
    b, by = bound_ms(nbytes, 2.0 * T * qb * P * d + 3.0 * T * qb * P)
    rows.append(("paged_distance", dargs, paged_distances,
                 paged_distances_ref,
                 lambda: torch.baddbmm(base, q, pages.transpose(1, 2),
                                       alpha=-2.0),
                 b, by, dict(T=T, QB=qb, P=P, d=d, NP=S * nps)))
    B = NQ
    for name, M, kern, plain in (
            ("bitonic_sort", 16, bitonic_sort, bitonic_sort_ref),
            ("bitonic_merge", 64, bitonic_merge, bitonic_merge_ref)):
        dd, ii, pp = sort_rows(B, M, dev, seed=M)
        if name == "bitonic_merge":
            dd, ii, pp = bitonic_sort_ref(dd, ii, pp)
            dd, ii, pp = (torch.cat([x[:, :32], x[:, 32:].flip(1)], 1)
                          for x in (dd, ii, pp))
        stages = int(math.log2(M))
        cmps = B * (M // 2) * (stages if name == "bitonic_merge"
                               else stages * (stages + 1) // 2)
        b, by = bound_ms(2 * B * M * 12, cmps)
        rows.append((name, (dd, ii, pp), kern, plain,
                     lambda dd=dd: torch.sort(dd, dim=-1, stable=True),
                     b, by, dict(B=B, M=M, payload_lanes=1)))
    out = []
    by_name = {k.name: k for k in KERNELS}
    for name, args, kern, plain, lib, b, by, shape in rows:
        ms, method = device_ms(lambda: kern(*args))
        plain_ms, _ = device_ms(lambda: plain(*args))
        library_ms, _ = device_ms(lib)
        host_ms = event_ms(lambda: kern(*args))
        k = by_name[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{k.source}",
                 "replaces": k.replaces, "launches": launches[name],
                 "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b, "bound_by": by, "library_ms": library_ms}
        emit({"phase": "timing", **entry, "shape": shape,
              "timed_by": method, "event_ms_per_call": host_ms})
        out.append(entry)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's main path runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels.build import build_all

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    emit({"phase": "build", "seconds": round(build_all(), 2)})

    t0 = time.perf_counter()
    T, qb, P, d, pages = main_path_tiles()
    errs = {"paged_distance": check_distance({
        "main path tiles": (T, qb, P, d, pages),
        "1M-vector store": (T, qb, P, d, 2**20 // P)}, dev)}
    errs["bitonic_sort"] = errs["bitonic_merge"] = check_topk(dev)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 2)})

    integer_main_path(dev)
    _, packed, launches = real_main_path(dev)
    kernels = time_kernels(packed, launches, errs, dev)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
