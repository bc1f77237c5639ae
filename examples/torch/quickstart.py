"""Quickstart on the PyTorch/CUDA port: build an NDSearch index, run the
distributed engine, check recall — the paper's core workload through the
port's public API (the twin of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/torch/quickstart.py                 # card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu
"""
import argparse

import torch

from repro_torch.core.engine import EngineParams, pack_for_engine, search_sim
from repro_torch.core.graph import build_vamana, brute_force_topk, recall_at_k
from repro_torch.core.luncsr import Geometry, LUNCSR, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.reorder import apply_reordering, degree_ascending_bfs
from repro_torch.data.vectors import VectorDataset
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
ap.add_argument("--n", type=int, default=4096)
ap.add_argument("--dim", type=int, default=64)
ap.add_argument("--shards", type=int, default=8)
ap.add_argument("--L", type=int, default=32)
ap.add_argument("--W", type=int, default=2)
ap.add_argument("--k", type=int, default=10)
ap.add_argument("--spec", type=int, default=4)
args = ap.parse_args()
dev = resolve_device(args.device)
S, QS = args.shards, 8                  # 8 queries per shard

# 1. data + graph (DiskANN-style construction)
ds = VectorDataset("quickstart", n=args.n, dim=args.dim, clusters=16,
                   intrinsic=12)
db = ds.materialize()
queries = ds.queries(S * QS)
adj, medoid = build_vamana(db, r=16)

# 2. static scheduling: degree-ascending BFS reorder (§VI-A)
order = degree_ascending_bfs(adj)
db, adj, medoid = apply_reordering(db, adj, order, entry=medoid)

# 3. LUNCSR index over an S-shard "pod" (striped page placement)
geom = Geometry(num_shards=S, page_size=64, pages_per_block=4,
                dim=db.shape[1])
index = LUNCSR.from_adjacency(db, adj, geom, entry=medoid, pref_width=4)
packed = pack_index(index, max_degree=16)

# 4. search (batch-wise dynamic allocating + speculative widening, §VI-B)
consts, egeom, entry = pack_for_engine(packed, device=dev)
sp = SearchParams(L=args.L, W=args.W, k=args.k)
params = EngineParams.lossless(sp, queries_per_shard=QS, max_degree=16,
                               spec_width=args.spec)
qsh = torch.as_tensor(queries.reshape(S, QS, -1))
ids, dists, stats = search_sim(consts, qsh, *entry, params, egeom,
                               device=dev)

# 5. verify against brute force
ids = ids.cpu().numpy().reshape(S * QS, -1)
true_ids, _ = brute_force_topk(db, queries, args.k)
recall = recall_at_k(ids, true_ids)
print(f"device     = {dev}")
print(f"recall@{args.k}  = {recall:.3f}")
print(f"rounds     = {int(stats['total_rounds'].max())}")
print(f"page reads = {int(stats['pages_unique'].sum())} "
      f"(vs {int(stats['items_recv'].sum())} without sharing)")
assert recall > 0.85
print("OK")
