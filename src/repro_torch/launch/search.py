"""ANNS driver — the paper's workload end-to-end, on the port.

Builds a Vamana (DiskANN-style) index over a synthetic dataset on the
host, applies the static scheduling (degree-ascending BFS reorder +
striped LUN-CSR packing), runs the sharded NDSearch engine
(``search_sim``) on the device and reports recall@k / QPS / locality
stats with the same JSON keys as the reference driver.

  PYTHONPATH=src python -m repro_torch.launch.search --dataset sift-1b
  PYTHONPATH=src python -m repro_torch.launch.search --device cpu \\
      --dataset tiny --n 512 --queries 32
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.core.engine import EngineParams, pack_for_engine, search_sim
from repro_torch.core.graph import (brute_force_topk, build_vamana,
                                    recall_at_k)
from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.reorder import apply_reordering, degree_ascending_bfs
from repro_torch.data.vectors import PAPER_DATASETS, VectorDataset
from repro_torch.utils import resolve_device


def build_index(db: np.ndarray, *, shards: int, page_size: int, r: int,
                reorder: str = "ours", pref_width: int = 0, seed: int = 0):
    """Host build: Vamana graph, reorder, LUN-CSR pack. Returns the
    (reordered) vectors and the :class:`PackedIndex`."""
    adj, medoid = build_vamana(db, r=r, seed=seed)
    if reorder == "ours":
        order = degree_ascending_bfs(adj)
        db, adj, medoid = apply_reordering(db, adj, order, entry=medoid)
    geom = Geometry(num_shards=shards, page_size=page_size,
                    pages_per_block=4, dim=db.shape[1], stripe="striped")
    idx = LUNCSR.from_adjacency(db, adj, geom, entry=medoid,
                                pref_width=pref_width)
    return db, pack_index(idx, max_degree=r)


def dataset(name: str, n: int = 0) -> VectorDataset:
    """The CLI's dataset: a paper stand-in, or ``tiny``; ``n`` overrides
    the size."""
    if name == "tiny":
        return VectorDataset("tiny", n=n or 2048, dim=64, clusters=16)
    ds = PAPER_DATASETS[name]
    return dataclasses.replace(ds, n=n) if n else ds


def run_search(packed, db, queries, *, shards: int, L: int, W: int, k: int,
               spec: int, kernel_mode: str, coalesce_qb: int, device):
    """Pack onto ``device``, run ``search_sim`` over the first
    ``queries`` rows (a multiple of ``shards``), score recall@k. Returns
    the report dict (reference keys plus device, host_syncs)."""
    dev = resolve_device(device)
    consts, geom, entry = pack_for_engine(packed, device=dev)
    nq = queries.shape[0]
    qs = nq - nq % shards or shards
    params = EngineParams.lossless(
        SearchParams(L=L, W=W, k=k), qs // shards, packed.max_degree,
        spec_width=spec, kernel_mode=kernel_mode, coalesce_qb=coalesce_qb)
    qsh = torch.as_tensor(queries[:qs].reshape(shards, qs // shards, -1),
                          device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids, _, stats = search_sim(consts, qsh, *entry, params, geom, device=dev)
    ids = ids.reshape(qs, -1).cpu().numpy()           # waits for the device
    dt = time.perf_counter() - t0
    true_ids, _ = brute_force_topk(db, queries[:qs], k)
    return {
        "kernel_mode": kernel_mode, "coalesce_qb": coalesce_qb,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "n": int(db.shape[0]), "queries": qs,
        "recall@k": round(float(recall_at_k(ids, true_ids)), 4),
        "qps": round(qs / dt, 1), "search_s": dt,
        "rounds": int(stats["total_rounds"].max()),
        "mean_dists_per_query": float(stats["n_dist"].double().mean()),
        "pages_unique": int(stats["pages_unique"].sum()),
        "items_recv": int(stats["items_recv"].sum()),
        "host_syncs": stats["host_syncs"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sift-1b",
                    choices=sorted(PAPER_DATASETS) + ["tiny"])
    ap.add_argument("--n", type=int, default=0, help="override dataset size")
    ap.add_argument("--queries", type=int, default=256)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--W", type=int, default=1)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--spec", type=int, default=0,
                    help="speculative 2nd-order prefetch width")
    ap.add_argument("--reorder", default="ours", choices=["ours", "none"])
    ap.add_argument("--kernel-mode", default="auto",
                    choices=["auto", "cuda", "ref", "torch"],
                    help="hot-path backend: the CUDA kernels (auto on a "
                         "card), their plain versions (ref), or inline "
                         "torch ops")
    ap.add_argument("--coalesce-qb", type=int, default=8,
                    help="per-page query-tile width in kernel modes: one "
                         "page read serves up to this many assignments "
                         "(0 = one page read per assignment)")
    ap.add_argument("--device", default="cuda",
                    help="torch device for the search (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds = dataset(args.dataset, args.n)
    db0 = ds.materialize()
    queries = ds.queries(args.queries, seed=args.seed + 1)
    print(f"dataset {ds.name}: n={db0.shape[0]} d={db0.shape[1]}")

    t0 = time.perf_counter()
    db, packed = build_index(
        db0, shards=args.shards, page_size=args.page_size, r=args.degree,
        reorder=args.reorder, pref_width=args.spec, seed=args.seed)
    build_s = time.perf_counter() - t0
    print(f"index built in {build_s:.1f}s "
          f"(reorder={args.reorder}, spec={args.spec})")
    if dev.type == "cuda" and args.kernel_mode in ("auto", "cuda"):
        from repro_torch.kernels.build import build_all
        build_all()                        # kernel build stays off the clock

    res = {"dataset": ds.name,
           **run_search(packed, db, queries, shards=args.shards, L=args.L,
                        W=args.W, k=args.k, spec=args.spec,
                        kernel_mode=args.kernel_mode,
                        coalesce_qb=args.coalesce_qb, device=dev),
           "build_s": round(build_s, 1)}
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
