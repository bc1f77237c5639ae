"""Two-stage retrieve/rank application on the PyTorch/CUDA port (the
twin of ``examples/two_stage.py``; the paper's Fig. 1 motivation): ANNS
retrieves candidate item vectors, a transformer ranker scores them.

Stage 1 (retrieve): NDSearch engine returns top-k neighbor ids+vectors.
Stage 2 (rank):     a reduced LM backbone scores each (query, candidate)
                    pair from pooled hidden states (DeepFM/dg-net style:
                    retrieved vectors are the model inputs).

  PYTHONPATH=src python examples/torch/two_stage.py                  # card
  PYTHONPATH=src python examples/torch/two_stage.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.engine import EngineParams, pack_for_engine, search_sim
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import Geometry, LUNCSR, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.data.vectors import VectorDataset
from repro_torch.models import ModelOpts, forward_hidden, init_params
from repro_torch.utils import resolve_device

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda",
                help="cuda (default; raises without a card) or cpu")
args = ap.parse_args()
dev = resolve_device(args.device)


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize()


K, NQ, DIM = 8, 32, 64

# ---- stage 1: retrieval over the item database --------------------------
ds = VectorDataset("items", n=4096, dim=DIM, clusters=16, intrinsic=12)
db = ds.materialize()
queries = ds.queries(NQ)
adj, medoid = build_vamana(db, r=16)
geom = Geometry(num_shards=4, page_size=64, pages_per_block=4, dim=DIM)
packed = pack_index(LUNCSR.from_adjacency(db, adj, geom, entry=medoid),
                    max_degree=16)
consts, egeom, entry = pack_for_engine(packed, device=dev)
sp = SearchParams(L=24, W=1, k=K)
params_e = EngineParams.lossless(sp, NQ // 4, 16)

t0 = time.time()
ids, dists, stats = search_sim(
    consts, torch.as_tensor(queries.reshape(4, NQ // 4, -1)), *entry,
    params_e, egeom, device=dev)
ids = ids.cpu().numpy().reshape(NQ, K)
t_retrieve = time.time() - t0
cand_vecs = db[np.clip(ids, 0, db.shape[0] - 1)]        # (NQ, K, DIM)

# ---- stage 2: rank with a reduced transformer backbone -------------------
cfg = reduced(get_config("llava-next-mistral-7b"))      # re-id style ranker
gen = torch.Generator(device=dev).manual_seed(0)
params = init_params(cfg, gen)
proj = 0.1 * torch.randn((DIM, cfg.d_model), generator=gen, device=dev)

# sequence = [query_embed, cand_1 ... cand_K]; score = head of last hidden
seq = torch.cat([torch.as_tensor(queries, device=dev)[:, None] @ proj,
                 torch.as_tensor(cand_vecs, device=dev) @ proj],
                dim=1)                                   # (NQ, 1+K, d)
tokens = torch.zeros((NQ, 1 + K), dtype=torch.int32, device=dev)
t0 = time.time()
with torch.no_grad():
    hidden, _ = forward_hidden(params, cfg, tokens,
                               opts=ModelOpts(remat="none", loss_chunk=32),
                               frontend_embeds=seq)
    w_score = 0.1 * torch.randn((cfg.d_model,), generator=gen, device=dev)
    scores = hidden[:, 1:] @ w_score                     # (NQ, K)
    rank = torch.argsort(-scores, dim=1)
sync()
t_rank = time.time() - t0

reranked = np.take_along_axis(ids, rank.cpu().numpy(), axis=1)
print(f"device: {dev}")
print(f"retrieve: {t_retrieve:.2f}s   rank: {t_rank:.2f}s")
print(f"retrieve share of end-to-end: "
      f"{100 * t_retrieve / (t_retrieve + t_rank):.0f}% "
      "(the paper's Fig.1 observation: ANNS dominates)")
print("query 0 retrieved :", ids[0].tolist())
print("query 0 reranked  :", reranked[0].tolist())
assert torch.isfinite(scores).all()
print("OK")
