"""Serving driver — batched prefill + decode with KV caches, optionally
retrieval-augmented (the paper's two-stage pipeline: the NDSearch engine
retrieves neighbour vectors that are prepended as soft-prompt
embeddings), on the port.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b --rag \\
      --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --reduced --rag --device cpu --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --reduced --rag --stream-retrieval --batch 2 --prompt-len 16 --gen 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --reduced --rag --device cpu --batch 2 --prompt-len 16 --gen 4

Every family of the reference serves: dense (gemma3-1b, gemma2-27b,
yi-34b, llama3-405b), vlm (llava-next-mistral-7b, the vision stub's
patches over the prompt prefix), moe (mixtral-8x7b, dbrx-132b), ssm
(mamba2-780m), hybrid (zamba2-1.2b) and encdec (seamless-m4t-medium,
the audio stub's frames as the encoder input, one per prompt position).
``--rag`` prepends retrieved soft prompts for the decoder-only families
without a frontend, as the reference's ``elif`` does.

Weights, prompts, frontend inputs and the soft-prompt projection are
random, drawn from ``--seed`` with a ``torch.Generator`` on the target
device. Prefill attention runs the flash-attention kernel, the retrieval
stage the paged SiN distance and bitonic kernels (on a card; their plain
versions on the CPU). Decode is one captured program per token, as the
reference's jitted step (:class:`StepFns`). Prints the reference CLI's
lines plus one JSON line with tok/s, prefill ms, decode ms per token
and the kernels' launch counts.
"""
from __future__ import annotations

import argparse
import itertools
import json
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, reduced
from repro_torch.core.capture import CACHE, tensor_ptrs, tree_leaves
from repro_torch.core.engine import EngineParams, pack_for_engine, search_sim
from repro_torch.core.graph import build_vamana
from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
from repro_torch.core.ref_search import SearchParams
from repro_torch.data.vectors import VectorDataset
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch.serve_stream import StreamingRetriever
from repro_torch.models import transformer as T
from repro_torch.models.frontend import frontend_shape
from repro_torch.utils import resolve_device

RAG_N = 2048                  # vectors in the retrieval stage's index


class StepFns:
    """The prefill and decode of one serving session: the reference's
    jitted pair (``make_step_fns``), where each generated token is one
    compiled program.

    ``decode`` runs ``T.decode_step`` through ``core.capture.CACHE`` as
    the program ``decode_step`` (one round per call): on a card it is
    captured as a CUDA graph on its first call and every later token is
    one replay, one launch from the host. The entry's key holds the
    session, the cfg, the opts, the batch, the cache's and the encoder's
    lengths and the ``data_ptr`` of every parameter and cache tensor the
    step reads or writes in place; its operand is the (B, 1) token
    tensor, its output the (B, V) logits, a static buffer that the next
    call overwrites (a caller that keeps logits copies them). The cache
    is the step's in-place state, so the capture's warm-up leaves it as
    it found it. ``capture=False`` runs the step eagerly on the card:
    the proof path that both agree. On the CPU the entry runs the step
    eagerly into the same static buffers. A capture that fails raises.
    ``prefill`` stays eager.

    The session owns one cache per (batch, cache length, encoder
    length), which :meth:`cache` zeroes in place at the start of each
    generation, so the addresses in the key hold and a warm-up
    generation's capture serves every later generation of those shapes.
    :meth:`close` (or leaving a ``with`` block) drops the session's
    entries and caches; the session's number in the key keeps a later
    session, whose tensors may reuse these addresses, from ever
    replaying them."""

    _sessions = itertools.count()

    def __init__(self, cfg, opts, capture: bool = True):
        self.cfg, self.opts, self.capture = cfg, opts, capture
        self.session = next(self._sessions)
        self.caches = {}
        self.keys = set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        for key in self.keys:
            CACHE.drop("decode_step", key)
        self.keys.clear()
        self.caches.clear()

    def cache(self, batch: int, cache_len: int, enc_len: int, device):
        """The session's cache of these shapes on ``device``, zeroed."""
        dev = resolve_device(device)
        key = (batch, cache_len, enc_len, str(dev))
        cache = self.caches.get(key)
        if cache is None:
            cache = self.caches[key] = T.init_cache(
                self.cfg, batch, cache_len, enc_len=enc_len,
                dtype=torch.float32, device=dev)
        else:
            for t in tree_leaves(cache):
                t.zero_()
        return cache

    def prefill(self, p, t, c, fe):
        return T.prefill(p, self.cfg, t, c, opts=self.opts,
                         frontend_embeds=fe)

    def decode(self, p, c, t):
        """One token (B, 1) against the cache c -> (logits (B, V), c)."""
        cfg, opts = self.cfg, self.opts

        def step(tokens):
            return T.decode_step(p, cfg, c, tokens, opts=opts)[0]
        if not self.capture:
            return step(t), c
        leaves = tree_leaves(c)
        key = (self.session, cfg, opts, t.shape[0],
               c["k"][0].shape[1] if "k" in c else 0,
               c["xk"][0].shape[1] if "xk" in c else 0,
               tensor_ptrs(*p.parameters(), *leaves))
        self.keys.add(key)
        logits = CACHE.run("decode_step", step, key, (t,), rounds=1,
                           state=tuple(leaves))
        return logits, c


def make_step_fns(cfg, opts, *, capture: bool = True) -> StepFns:
    """The session's prefill/decode (:class:`StepFns`): the decode step
    captured once and replayed per token, or (``capture=False``) run
    eagerly."""
    return StepFns(cfg, opts, capture=capture)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def greedy_generate(params, cfg, tokens, *, gen: int, opts,
                    frontend_embeds=None, enc_len: int = 0, step_fns=None,
                    cache_len: int = 0, stats: dict | None = None,
                    keep_logits: bool = False):
    """Greedy prefill + ``gen - 1`` decode steps -> (B, gen) int32 tokens.

    ``step_fns`` is the session (:func:`make_step_fns`) whose cache of
    these shapes the generation resets and fills, and whose captured
    decode it replays; without one the call is a session of its own.
    ``cache_len`` pins the KV-cache length (default Sp + gen);
    ``enc_len`` the encoder cache's (encdec; at least 1, as the
    reference sizes it). With
    ``stats`` (a dict) the device is synchronised after prefill and at
    the end, and ``prefill_s``, ``decode_s``, ``logits_finite`` (every
    step's logits finite) and ``top2_gap`` ((B, gen) numpy: each greedy
    pick's logit margin over the runner-up) are filled in, and with
    ``keep_logits`` ``logits`` (gen, B, V): every step's, copied."""
    if step_fns is None:
        with make_step_fns(cfg, opts) as fns:
            return greedy_generate(
                params, cfg, tokens, gen=gen, opts=opts,
                frontend_embeds=frontend_embeds, enc_len=enc_len,
                step_fns=fns, cache_len=cache_len, stats=stats,
                keep_logits=keep_logits)
    B, Sp = tokens.shape
    dev = tokens.device
    cache = step_fns.cache(B, cache_len or (Sp + gen), max(enc_len, 1), dev)
    out, gaps, kept = [], [], []

    def pick(logits):
        # before the next step overwrites the captured step's logits
        out.append(logits.argmax(-1).to(torch.int32)[:, None])
        if stats is not None:
            top2 = logits.topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            if keep_logits:
                kept.append(logits.clone())
        return torch.isfinite(logits).all()

    t0 = time.perf_counter()
    logits, cache = step_fns.prefill(params, tokens, cache, frontend_embeds)
    finite = pick(logits)
    if stats is not None:
        _sync(dev)
        t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = step_fns.decode(params, cache, out[-1])
        finite = finite & pick(logits)
    out = torch.cat(out, dim=1)
    if stats is not None:
        _sync(dev)
        stats.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                     logits_finite=bool(finite),
                     top2_gap=torch.stack(gaps, 1).cpu().numpy())
        if keep_logits:
            stats["logits"] = torch.stack(kept)
    return out


def retrieval_index(d: int, seed: int = 0):
    """The RAG stage's index: ``RAG_N`` clustered d-dim vectors, a Vamana
    graph (degree 16) built on the host, packed as one shard of 64-vector
    pages. Returns (vectors, PackedIndex)."""
    ds = VectorDataset("serve-db", n=RAG_N, dim=d, clusters=16, seed=seed)
    db = ds.materialize()
    adj, medoid = build_vamana(db, r=16, seed=seed)
    geom = Geometry(num_shards=1, page_size=64, pages_per_block=4, dim=d)
    idx = LUNCSR.from_adjacency(db, adj, geom, entry=medoid)
    return db, pack_index(idx, max_degree=16)


def soft_prompt_from_retrieval(cfg, queries: np.ndarray, k: int = 4,
                               seed: int = 0, kernel_mode: str = "auto",
                               coalesce_qb: int = 8,
                               streaming: bool = False, device="cuda",
                               index=None):
    """Two-stage pipeline: NDSearch retrieval -> soft-prompt vectors.

    Builds the retrieval index (or takes ``index``, a
    :func:`retrieval_index` result), retrieves the top-k neighbours of
    each (B, d) query with ``search_sim`` on ``device`` and returns
    (vectors (B, k, d), ids (B, k), dists (B, k)) as numpy arrays; the
    caller projects the vectors into the model's embedding space.
    ``kernel_mode`` selects the retrieval hot-path backend
    (core/backend.py), ``coalesce_qb`` the kernel modes' per-page
    query-tile width. With ``streaming`` the batch goes through the
    streaming scheduler's slot pool (retrieval as a continuous-batching
    client, bit-identical results) instead of one frozen ``search_sim``
    batch."""
    dev = resolve_device(device)
    B, d = queries.shape
    db, packed = index if index is not None else retrieval_index(d, seed)
    if streaming:
        retriever = StreamingRetriever(
            db, packed, L=16, W=1, k=k, num_slots=max(1, B // 2),
            kernel_mode=kernel_mode, coalesce_qb=coalesce_qb, device=dev)
        vecs, ids, dists, _ = retriever.retrieve(
            np.asarray(queries, np.float32))
        return vecs, ids, dists
    consts, egeom, entry = pack_for_engine(packed, device=dev)
    params = EngineParams.lossless(SearchParams(L=16, W=1, k=k), B, 16,
                                   kernel_mode=kernel_mode,
                                   coalesce_qb=coalesce_qb)
    q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)[None]
    ids, dists, _ = search_sim(consts, q, *entry, params, egeom, device=dev)
    ids = ids[0].cpu().numpy()
    vecs = db[np.clip(ids, 0, db.shape[0] - 1)]           # (B, k, d)
    return vecs, ids, dists[0].cpu().numpy()


def serve_inputs(cfg, *, batch: int, prompt_len: int, rag: bool,
                 rag_dim: int, seed: int, device, kernel_mode: str = "auto",
                 coalesce_qb: int = 8, index=None, streaming: bool = False):
    """Random weights and prompts from ``seed`` on ``device``, plus the
    frontend embeddings: the vision stub's patches, the audio stub's
    frames (the encoder input, one per prompt position: the encoder
    length is ``prompt_len``), or (``rag``, the other families) the
    projected retrieved neighbours over the first k prompt positions
    (retrieved through the streaming scheduler with ``streaming``).
    Returns (params, tokens, frontend_embeds or None, retrieval or
    None), the retrieval a dict of the numpy ``queries``, ``ids`` and
    ``dists``."""
    T.check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           generator=gen, device=dev)
    fe = retrieval = None
    shape = frontend_shape(cfg, batch, prompt_len)
    if shape is not None:
        fe = 0.05 * torch.randn(shape, generator=gen, device=dev)
    elif rag:
        q = torch.randn((batch, rag_dim), generator=gen,
                        device=dev).cpu().numpy()
        # the soft prompt can't be wider than the prompt it overwrites
        vecs, ids, dists = soft_prompt_from_retrieval(
            cfg, q, k=max(1, min(4, prompt_len)), kernel_mode=kernel_mode,
            coalesce_qb=coalesce_qb, streaming=streaming, device=dev,
            index=index)
        proj = torch.randn((vecs.shape[-1], cfg.d_model), generator=gen,
                           device=dev) * 0.02
        fe = torch.as_tensor(vecs, device=dev) @ proj     # (B, k, d_model)
        retrieval = {"queries": q, "ids": ids, "dists": dists}
    return params, tokens, fe, retrieval


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--rag", action="store_true",
                    help="two-stage: retrieve soft prompts via NDSearch")
    ap.add_argument("--rag-dim", type=int, default=32,
                    help="query-embedding dim of the RAG retrieval stage")
    ap.add_argument("--stream-retrieval", action="store_true",
                    help="route the RAG retrieval through the streaming "
                         "scheduler's slot pool (continuous batching) "
                         "instead of one frozen search_sim batch")
    ap.add_argument("--kernel-mode", default="auto",
                    choices=["auto", "cuda", "ref", "torch"],
                    help="hot-path backend: the CUDA kernels (auto on a "
                         "card), their plain versions (ref), or inline "
                         "torch ops (retrieval only; attention takes ref)")
    ap.add_argument("--coalesce-qb", type=int, default=8,
                    help="kernel modes: per-page query-tile width for the "
                         "retrieval distance stage (0 = per-item)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opts = T.ModelOpts(attn_mode="ref" if args.kernel_mode == "torch"
                       else args.kernel_mode)
    reset_launch_counts()
    params, tokens, fe, retrieval = serve_inputs(
        cfg, batch=args.batch, prompt_len=args.prompt_len, rag=args.rag,
        rag_dim=args.rag_dim, seed=args.seed, device=dev,
        kernel_mode=args.kernel_mode, coalesce_qb=args.coalesce_qb,
        streaming=args.stream_retrieval)
    retrieval_launches = launch_counts()
    enc_len = args.prompt_len if cfg.frontend == "audio" else 0
    if retrieval is not None:
        print("retrieved neighbor ids:", retrieval["ids"][:, :4].tolist())

    # warm up (kernel build, allocator, the decode step's capture) with
    # the full run's cache shapes, then time steady state
    with make_step_fns(cfg, opts) as step_fns:
        t0 = time.perf_counter()
        greedy_generate(params, cfg, tokens, gen=min(2, args.gen), opts=opts,
                        frontend_embeds=fe, enc_len=enc_len,
                        step_fns=step_fns,
                        cache_len=args.prompt_len + args.gen)
        _sync(dev)
        warm_s = time.perf_counter() - t0
        reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, tokens, gen=args.gen, opts=opts,
                              frontend_embeds=fe, enc_len=enc_len,
                              step_fns=step_fns, stats=stats)
        dt = time.perf_counter() - t0
    out = out.cpu().numpy()
    print(f"generated {out.shape} tokens in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s, excl. "
          f"{warm_s:.2f}s warmup)")
    print("sample:", out[0, :16].tolist())
    if not stats["logits_finite"]:
        raise RuntimeError("non-finite logits")
    print(json.dumps({
        "arch": cfg.name, "device": torch.cuda.get_device_name(dev)
        if dev.type == "cuda" else "cpu",
        "batch": args.batch, "prompt_len": args.prompt_len, "gen": args.gen,
        "rag": args.rag, "stream_retrieval": args.stream_retrieval,
        "tok_s": args.batch * args.gen / dt,
        "prefill_ms": stats["prefill_s"] * 1e3,
        "decode_ms_per_token": (stats["decode_s"] * 1e3
                                / max(1, args.gen - 1)),
        "launches": {"retrieval": retrieval_launches,
                     "generate": launch_counts()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
