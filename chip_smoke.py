#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON object per line (a phase that fails
raises, so the script exits nonzero and prints no result line). The
sift-1b builds (search and routed) run in two child processes from
phase 2 on; phases 6b to 7c run their integer parts first, while the
builds finish, and their sift-1b parts after phase 6; each part prints
its seconds:

  1. device  — the card's name and power limit (as nvidia-smi prints
               them), torch and CUDA versions, whether torch offers
               conditional CUDA-graph nodes; TF32 is switched off.
  2. build   — compile the CUDA kernels from src/repro_torch/kernels/csrc;
               each kernel's registers and spills as ptxas reports them.
  3. kernels — hold each search kernel against its plain PyTorch version
               on the card: the SiN distance at the main path's tile
               shapes (page-sorted, as dispatched, and unsorted) and on a
               1M-vector (512 MiB) paged store, exact on integer-valued
               inputs and within RTOL_REAL on real ones; its bf16
               instantiations (bf16 queries, a bf16 store, both) at the
               main path's tiles, on the 1M-vector store and at the
               router's and tiered shapes, the same way and bit for bit
               against the f32 kernel on the upcast operands;
               the distance at the router's shape (T 8 shards, QB 2048
               queries, P 8 centroids, d 128) and at phase tiered's
               (a frame buffer of 24 pages per shard);
               the bitonic sort and merge exactly, with a payload lane,
               ties and duplicated (dist, id, payload) entries, -0.0 /
               NaN / inf, in both bodies (registers up to M 128, shared
               memory up to 2048), also at the routed path's shapes (the
               route's sort, B 2048 x M 8; the fusion merge, B 2048 x
               M 32);
               the fused Gather merge (merge_unsorted) bit for bit
               against its plain version, the two-launch composition
               (sort, then merge) and its other body: ties across the
               two sides, duplicates, invalid and all-invalid rows,
               out_w below the width, ragged row counts, -0.0 / NaN /
               inf, widths up to 2048, and spec 4's proposals
               (W * (R + spec) = 20);
               the sort and merge with several payload lanes (the lanes
               launch: positions through the network, an epilogue that
               permutes every lane): the sort at B 2048, M 32 and M 256
               with 3 lanes (i32, f32, i32), the merge pass at M 64 with
               2, one launch each, bit for bit against the plain
               versions and the other body (NaN payloads, signed zeros,
               (dist, id) ties whose lanes differ).
  4. attn_kernels — the flash-attention kernel against its plain
               version: gemma3-1b's geometry with its 512 window and
               full, a gemma2-like softcap, bf16, a non-aligned S through
               the op, S not a multiple of the 64-row q block with a
               window below it, and non-causal; the other families'
               prefill shapes: mixtral (GQA 32/8, dh 128, window 4096),
               zamba2's shared block (dh 64, window 4096), seamless's
               encoder (non-causal), decoder self-attention and
               cross-attention through attention_op over Skv 1024 and
               over a padded Skv 1088 with kv_valid 1000 (the plain
               version over the valid rows only); each within its stated
               tolerance. Then the training path's pair (the forward
               with its row log-sum-exp, the backward kernel): gemma3-1b
               local and global, softcap 50 at dh 128, bf16, S 992 with
               window 40 and the padded cross shape through attention_op
               under autograd, non-causal, dh 64 and dh 16: out and lse
               against attention_fwd_ref, dq, dk, dv against
               attention_bwd_ref on the kernel's own out and lse; the
               backward twice bit for bit, and the serving launch (no
               lse) bit for bit the lse launch's output.
  5. int     — search_sim on an integer-valued index: cuda mode on the
               card, captured as CUDA graphs of SEARCH_CHUNK predicated
               rounds, equals the same search uncaptured (capture=False)
               on the card and ref mode on the CPU bit for bit; one host
               read per chunk. Then traversal.search (the single-shard
               twin, its round loop on the host) in cuda mode on the card
               against ref mode on the CPU, bit for bit, with its
               launches (the fused Gather merge carries its proposal
               sort: no standalone sort or merge launch).
  6. main    — the sift-1b stand-in at the CLI defaults (n=16384, d=128,
               8 shards, page 64, degree 16, L=32, W=1, k=10, 256
               queries): host build (with prefetch lists of 8, which
               spec 0 never reads), then search_sim in auto mode (the
               kernels): a warm-up call captures the chunk, the measured
               call replays it. Launch counts are zeroed just before and
               read just after; every search kernel must have launched
               (the distance kernel and the fused Gather merge once per
               round the device ran — every replay runs its chunk's
               SEARCH_CHUNK rounds, dead ones included — the standalone
               sort and merge not at all); recall@k, rounds,
               pages_unique and items_recv must equal the port's
               standing counts (MAIN_COUNTS); the captured search must
               equal the uncaptured one bit for bit. Printed: captures,
               replays, host syncs, dead rounds, host ms per round, QPS
               over REPEATS more calls and uncaptured; then a profiled
               call (the device's idle share).
  6b. engine_variants — the engine's static variants and fault plans.
               (a) Phase int's integer index: search_sim captured in
               cuda mode with gather_vectors (the baseline that moves
               vectors: no distance launch, the fused Gather merge once
               per device round), with payload_bf16 (the bf16-query
               distance instantiation once per device round) and after a
               block refresh (frac 0.5), each equal to CPU ref mode bit
               for bit and to NDP's ids, dists, rounds and n_dist; then
               stream_search under a delay plan, a kill plan with a
               deadline, page corruption ("neg", 0.08) with the guard
               and NaN corruption without it, each equal to CPU ref mode
               per query. (b) Phase main's sift-1b build: search_sim
               with gather_vectors and with payload_bf16 beside NDP:
               recall@k, rounds, items_recv, QPS and the modelled bucket
               bytes of the exchange per round; the
               baseline must return NDP's ids, bf16 payloads keep recall
               within RECALL_TOL. The bf16-query instantiation's launches
               in the kernels line are payload_bf16's measured search.
  7. stream  — the streaming scheduler (launch/serve_stream.py's
               stream_search) on the same host builds; its chunks run
               as captured CUDA graphs (one capture per session's chunk
               program, in the warmup; one host read per chunk). (a)
               The integer index: the captured stream on the card equals
               the uncaptured one and the same stream in ref mode on the
               CPU in every per-query record, and one-shot search_sim in
               cuda mode in ids, dists, rounds and n_dist, bit for bit,
               at spec 0 and 4. (b) The sift-1b stand-in: 2048 queries,
               Poisson arrivals at 8 per round into a 32-slot-per-shard
               pool, round chunk 8, in-device admission, spec 4: refill
               static, refill dynamic and frozen runs, each with QPS
               (and STREAM_REPEATS more sessions'), latency
               percentiles, occupancy, captures, replays, syncs,
               dead rounds, host ms per round, recall@10, launch counts,
               the uncaptured twin's QPS and a profiled window (the
               refill static run also a host+device one). Checks: one
               distance and one fused Gather-merge launch per round the
               device ran, none of the standalone sort and merge; the
               stream's first TWIN_QUERIES queries, captured, equal the
               same session uncaptured bit for bit; the static run takes 417 rounds and its ids equal
               one-shot search_sim's (up to a distance near-tie);
               dynamic recall within 0.01 of static; refill occupancy
               above frozen.
  7a. tiered — the tiered page store (core/pagestore.py). (a) Phase
               int's integer vectors rebuilt in 8-vector pages (32 per
               shard, degree 8, prefetch lists of 2): 64 queries at
               Poisson 0.25 per round into 2 slots per shard, chunk 4;
               half-resident sessions (prefetch on and off, in-device
               and host-paced admission, a wrapping ring of 6) on the
               card equal CPU ref mode in every per-query record, the
               stalls, the store's counters and its final residency;
               full residency equals the untiered session; each session
               captures once, keeps its consts' addresses across
               boundaries, reads once per chunk and launches one
               distance and one fused merge per device round; the
               ring-wrapping session (spaced arrivals, ring 6), run on
               an empty capture cache under CaptureGuard, builds exactly
               one engine_run_chunk_admit entry and its ids and dists
               equal CPU ref mode's untiered session without a ring; 2
               frames raise the livelock guard. (b) Phase main's sift-1b
               build, 256 queries at Poisson 0.25 into 2 slots per shard, chunk
               4, spec 2, from 32, 28, 24 and 20 frames of 32 per shard,
               prefetch on and off, beside the untiered session: every
               row's ids equal the untiered ids; per row QPS, latency,
               stalls per query, the store's counters, bytes copied to
               the card, host ms per boundary, queries per clock round,
               launches and the device idle share (the replays times
               one replay's device time, over the wall time). (c) A
               2^20-vector store (8 x 2048 pages of 64 x 128 f32, 512 MiB
               pinned) under 512 frames per shard, driven through
               boundary() with 64 demanded pages per shard: frames equal
               the cold tier row for row; the demand path's host ms and
               GB/s against one pinned copy_, and whether a staged
               prefetch copy overlaps a kernel loop on the current
               stream.
  7b. live  — the live index (core/live.py). (a) Phase tiered's
               integer build (phase int's vectors in 8-vector pages,
               degree 8) and traffic (64 queries at Poisson 0.25, 2
               slots per shard, chunk 4) with Poisson inserts (integer
               payloads next to the queries) and deletes, a delta of 16:
               zero churn equals the frozen stream; churn sessions (two
               swaps or more) flat, on a half-resident tiered store and
               routed at topr 8, each captured on the card equal to the
               same session uncaptured and in CPU ref mode in every
               per-query record, the live counters and the final epoch
               (external ids, tombstones, the delta), one capture per
               session, one distance and one fused merge per device
               round. Twin sessions reuse the first one's reindexes
               (memo_reindex). (b) The sift-1b stand-in from phase main's
               graph with the stream phase's traffic: zero churn equals
               phase stream's refill static session (ids, dists, rounds,
               dispatches); churn at the reference bench's rates (0.35
               inserts, 0.1 deletes per round, CHURN's delta) on a live
               set of the stand-in's first CHURN vectors (built in the
               host pool from phase 2 on): at least one swap, the
               reindex's host seconds, the swap's, delta hits, deletes,
               swap stalls, p99 in rounds and wall ms against the static
               session, recall@10 against the final live set, captures,
               launches. (c) Live sessions on a tiered store (phase
               tiered's traffic, 28 frames, delta 512, no swap): prefetch
               on with the stage's copy queued after the live consts'
               (the scheduler's order) and before them, in turns (A B B
               A), then demand-only.
  7c. routed — two-tier routed serving (core/router.py). (a) Phase
               int's integer data as a routed build (8 spatial shards,
               page 64, degree 16, 8 centroids per shard): routed
               sessions captured on the card at topr 2 and 8, in-device
               and host-paced admission, down_shards {1}, a kill under a
               deadline, and the flat stream with a ring of 4 under
               block and shed, each equal to CPU ref mode in every
               per-query record; per routed session one router distance
               launch, one route sort, R - 1 fusion merges and at
               most one capture. (b) The sift-1b stand-in as a routed build
               (n 16384, d 128, 8 shards, page 64, degree 16, 8
               centroids per shard, prefetch lists of 4): the stream
               phase's 2048 Poisson queries at topr 2 (default leg_L)
               and topr 8, each with recall@10, QPS, rounds, legs, work
               per shard, distances per query, latency percentiles,
               syncs, captures, launches per device round, a profiled
               window's device idle share and the route's time; at
               topr 8 every query equals the flat stream_search on the
               same index. The phase's seconds and the build's host
               seconds are printed.
  7d. mesh   — multi-device search (launch/mesh.py, search_distributed,
               the mesh stepper) on an engine mesh of one rank: a NCCL
               process group in this process (a loopback rendezvous, a
               timeout on every collective), destroyed after each part.
               (a) Phase int's integer index: search_distributed
               captured on the card (the all-to-alls and all-reduces
               inside the graph) equals the same search uncaptured,
               search_sim on the card and CPU ref mode, bit for bit; a
               mesh stream (refill, chunk 8, in-device admission, spec
               4) and a routed mesh session at topr 2 (phase routed's
               integer build) equal their sim sessions on the card and
               CPU ref mode in every record; one capture each, one
               distance and one fused merge per device round. (b) Phase
               main's sift-1b build: search_distributed returns phase
               main's ids and dists, the mesh stream session phase
               stream's refill static ids and dists; beside the sim
               driver, in turns: QPS, syncs, captures, launches per
               device round, a profiled window's device idle share and
               the share of device time in NCCL's kernels. At world 1
               the collectives are pure overhead.
  8. serve   — gemma3-1b at full width (26 layers, d_model 1152, vocab
               262144; random weights from a seed) through
               launch/serve.py's functions in auto mode: RAG retrieval
               (a 2048-vector index, the search kernels), then batch 4 x
               prompt 1024 greedy generation of 32 tokens.
  8b. serve_families — the other model families the same way, 16
               greedy tokens: mixtral-8x7b at full width with 8 of its
               32 layers (f32; 32 layers need ~180 GiB) and RAG k=4,
               mamba2-780m with 24 of its 48 layers, zamba2-1.2b with 20
               of 38 (3 shared-block groups and a 2-layer SSD tail; RAG
               k=4) and seamless-m4t-medium (the audio stub's frames as
               the encoder input) at full size. One body serves 8 and 8b
               (SERVE_CASES); per
               config: counts are zeroed before each stage and read
               after it: the retrieval launches the search kernels and
               its ids and distances agree with the CPU's plain
               versions; a generation launches one flash kernel per
               prefill attention (gemma 26, mixtral 8, mamba2 0, zamba2
               3, seamless 36) and none in decode; the prefill's logits
               within LOGIT_RTOL x max |logit| of plain attention's on
               the card, greedy tokens equal but at a near-tie;
               prefill + 3 decode steps equal logits_fn over the longer
               sequence within 5e-3 (tests/test_models_decode.py's
               tolerance; mixtral at capacity factor E) and within
               LOGIT_RTOL x max |logit|. Decode runs as the reference's
               jitted decode: the session (make_step_fns) captures
               decode_step once as a CUDA graph (one capture per case,
               counted by CaptureGuard over the warm-up, the timed
               generation and the profiled replays) and replays it per
               token; an eager twin (capture=False) runs the same
               generation, with equal tokens, and the logits' largest
               difference is printed. One line each: tok/s, prefill
               ms, decode ms per token and decode idle share both ways,
               graph and kernel launches per token both ways, peak GiB,
               idle shares, the prefill's top device ops, one eager
               decode step's host ops (mixtral also drop_frac and
               lb_loss at the serving capacity factor).
  8c. train — gemma3-1b at full width (f32 weights from the seed, TF32
               off) trained through launch/train.py at batch 4 x
               sequence 1024, remat full, loss chunk 512, AdamW lr 3e-4,
               warmup 5. (a) One step's loss and gradients through the
               kernels against the same step with plain attention on the
               card (attn_mode "ref"): loss within 1e-5, global grad
               norm within 1e-4 (relative), the worst per-leaf relative
               error printed. (b) 10 steps through train(): every loss
               finite, none skipped, the loss of step 0's batch lower
               after the run than at step 0, and every step launching
               exactly 52 flash forwards (26 layers, twice with remat),
               26 flash backwards and no search kernel. (c) The run's
               line: ms per step (median of steps 3-10), tokens/s, peak
               GiB, model-FLOP share of 67 TFLOP/s, and one more step
               profiled (device idle share, top device ops). (d) The
               restart drill in a fresh process (chip_smoke.py
               --restart-drill, CUBLAS_WORKSPACE_CONFIG=:4096:8,
               deterministic algorithms on): reduced gemma3-1b, 12
               steps, a failure injected at step 7, checkpoints every 5
               steps; the resumed run's parameters and optimizer state
               equal an uninterrupted run's bit for bit. (e) Part dots:
               the same cell under --remat dots (the outputs of the
               products with no batch dimension kept, the rest
               recomputed), 6 steps in this process: every step's loss
               and grad norm bit for bit the full run's same step, 52
               flash forwards and 26 backwards per step; ms per step
               (median of steps 3-6), tokens/s and peak GiB beside the
               full run's.
  8c'. train_mesh — the sharded step (launch/train.py --mesh 1,1, a
               one-rank NCCL group on a loopback rendezvous): (a) phase
               train's cell, 5 steps, each step's loss and grad norm
               within 1e-6 of phase train's same step (and whether bit
               for bit), ms per step beside phase train's, 52 flash
               forwards and 26 backwards per step, the collectives the
               step counts (an axis of one rank launches none) and the
               NCCL kernels of one profiled step; (b) mixtral-8x7b at
               full width cut to 1 of 32 layers, batch 2 x 1024, 3 steps
               unsharded and through --mesh 1,1: finite losses, equal
               within 1e-6; ms per step, peak GiB, the flash launches;
               (c) families: mamba2-780m (8 of 48 layers), zamba2-1.2b
               (one hybrid group: 6 SSD layers and the shared block) and
               seamless-m4t-medium (2 + 2 of 12 + 12 layers) at full
               width, batch 2 x 1024, 3 steps unsharded and through
               --mesh 1,1: finite, bit-equal; ms per step, peak GiB,
               flash forward and backward launches per step (none for
               mamba2, some for zamba2 and seamless); (d) phase train's
               cell through --mesh 1,1 --remat dots, 3 steps, bit for
               bit phase train's dots run.
  8d. analysis — the trace-discipline suite on the card (under 60 s):
               (a) the op audit (repro_torch.analysis.op_audit) with
               device "cuda" over every chunk program: no sync op, no
               float64, the frame install in place, and paged_distance
               and the fused Gather merge launched once per round; (b)
               the cost model (repro_torch.launch.opanalysis) over one
               uncaptured chunk of phase main's search: operations and
               bytes per round, by kernel and by op, and the share of
               3.35 TB/s that phase main's device time per round
               implies; (c) one gemma3-1b train step (phase train's shape) counted by the
               cost model beside model_flops (the counted step holds
               remat's second forward and the optimizer).
  8e. plan  — the planning half on the host (meta tensors, no card):
               (a) launch/dryrun.py, in a child process from phase 2
               on: the engine cell on both production meshes (256 and
               512 ranks), one train_4k cell per family
               on the 16 x 16 mesh and the five full-attention archs'
               long_500k skips: every record ok or the reference's skip;
               (b) phase train's own cell planned at mesh data 1 x model
               1 beside this run: predicted operations against phase
               analysis's count of the same step (within 1%), the
               planned parameter and optimizer bytes against the live
               state's (equal), the predicted peak against
               max_memory_allocated over one step (ratio printed), the
               roofline bound against phase train's ms per step; (c)
               one factored AdamW step of gemma3-1b at full width: a
               finite loss, finite moments, and state_tree's v in the
               reference's r/c structure; (d) phase train's dots cell
               planned the same way as (b), beside the cost model's
               count of one real dots step on the card and that step's
               peak. Then the phase's seconds.
  9. timing  — each kernel at its path's shapes: its time, its bound,
               the plain version's time and one library call's (the
               distance kernel's bf16 instantiations on the same tiles,
               their bound counting bf16 operands' halved bytes); flash
               attention also at gemma3-1b's global layer (window 0)
               and with its lse (the training launch), its backward at
               gemma3-1b's local and global layers (the library call:
               autograd's backward of SDPA on repeated kv; beside it
               the first design's time as earlier_ms),
               and at the other families' prefill shapes (mixtral,
               zamba2's shared block, seamless's encoder, decoder self-
               and cross-attention),
               the backward also at the dh-64 training shapes (B 2:
               zamba2's shared block, window 4096; seamless's encoder,
               decoder self-attention and cross-attention), the sort
               with 3 payload lanes at B 2048, M 32 (the library call:
               torch.sort and a gather of each lane),
               the fused Gather merge also at spec 4's proposals (LB 20),
               the distance at the router's shape and at the tiered
               sessions' (a frame buffer of 24 pages per shard), the
               standalone sort and
               merge also at the search's old proposal shapes, each on a
               line of its own; the standalone sort and merge at the
               routed path's shapes (their launches: the sift topr-2
               routed session's); each bitonic kernel also at one row of
               two entries and each distance row at one tile of one
               query row (the card's one-launch floor; the router and
               tiered rows with baddbmm as the library call, as the
               search rows). Measured in a
               fresh process (chip_smoke.py --timing) and printed with
               each kernel's launches on its path.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Exits nonzero when no CUDA device is
present, and when the repository's package is missing.

``chip_smoke.py --distance-rows [SRC]`` runs no phase: it times the
distance kernel's rows of phase 9 (its four instantiations at the search
tiles, the router's and tiered shapes; 3 traces of 200 calls each, the
least) with the repro_torch package under SRC (default: this checkout's
src) and prints them as one JSON line, so that another checkout's kernel
is timed on the same rows: alternate the two SRCs in one session.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
if sys.argv[1:2] == ["--distance-rows"] and len(sys.argv) > 2:
    sys.path.insert(0, str(Path(sys.argv[2]).resolve()))

# recall@k of `python -m repro.launch.search --kernel-mode jnp` (the
# reference package, CLI defaults: sift-1b stand-in, n=16384) on the CPU
REFERENCE_RECALL = 0.6719
RECALL_TOL = 0.01
SEARCH_KERNELS = ("paged_distance", "bitonic_merge_unsorted")
# the search path's Gather merge: candidate list L, proposals W * degree
# (W * (degree + spec) = 20 at spec 4, the streaming phase's width)
GATHER = dict(R=256, LA=32, LB=16, LB_SPEC=20)
# real-valued inputs: the kernel's sequential FMA chain over d and the
# plain version's batched product sum in different orders
RTOL_REAL = 1e-5
# flash attention vs its plain version: the online softmax sums in
# another order than the one-shot softmax (f32); bf16 rounds the output
ATTN_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# gemma3-1b prefill logits, kernel vs plain attention on the card: the
# per-layer differences (~1e-7) pass through 26 layers of random weights;
# the bound is relative to the largest |logit|
LOGIT_RTOL = 1e-4
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM bf16 on the tensor cores, dense


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def drop_traces() -> None:
    """Free the torch.profiler traces just taken. Their events (some
    million Python objects per stream window) sit in reference cycles
    that only the cyclic collector frees; left there, every later full
    collection walks them all, inside whatever is being timed then."""
    gc.collect()


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


def device_ms(fn, iters: int = 50, warmup: int = 5, tries: int = 3):
    """(mean device-kernel ms per call of ``fn()``, method): the sum of
    the card's kernel times per call, from torch.profiler. Every call
    launches at least one kernel, so a trace with fewer than ``iters``
    kernels lost records and is taken again; CUDA events when no trace
    is whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kern = device_kernel_us(prof).values()
        if sum(c for _, c in kern) >= iters:
            return sum(us for us, _ in kern) / 1e3 / iters, "profiler"
    return event_ms(fn, iters, warmup), "events"


def bound_ms(nbytes: float, ops: float, bf16_ops: float = 0.0):
    """(least time in ms, what bounds it) for moving ``nbytes`` through
    HBM and doing ``ops`` f32 operations outside the tensor cores and
    ``bf16_ops`` bf16 ones on them."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS + bf16_ops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def ptxas_report() -> list:
    """Registers and spill bytes of every kernel entry that this process
    compiled, from nvcc's -Xptxas -v output."""
    from repro_torch.kernels.build import BUILD_LOGS
    out = []
    for src, log in BUILD_LOGS.items():
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                out.append({"source": src, "entry": m.group(1)})
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and out:
                out[-1].update(spill_stores=int(m.group(1)),
                               spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and out:
                out[-1]["registers"] = int(m.group(1))
    names = subprocess.run(["c++filt"], input="\n".join(
        e["entry"] for e in out), capture_output=True, text=True)
    if names.returncode == 0:
        for e, name in zip(out, names.stdout.splitlines()):
            m = re.search(r"\w+_kernel(<[^()]*>)?", name)
            e["entry"] = m.group(0) if m else name
    return out


# the CLI defaults: the shape of the main path
SHARDS, N, DIM, PAGE, DEGREE, L, W, K, NQ, QB = (8, 16384, 128, 64, 16, 32,
                                                 1, 10, 256, 8)
# the routed path's kernel shapes (phase routed (b)): the router's
# distance tiles (T, QB, P, d, NP, page-sorted) — one tile per shard, the
# 2048 stream queries against the shard's 8 centroids; the route's sort
# (B, M) of every query's 8 shard scores; the fusion merge row (B, M) =
# A(10) ++ filler(12) ++ reversed(B(10))
ROUTER_TILES = (SHARDS, 2048, 8, DIM, SHARDS, True)
ROUTE_SORT = (2048, SHARDS)
FUSE_MERGE = (2048, 32)


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


def tiered_tiles():
    """(T, QB, P, d, pages) of the phase-B distance launch of phase
    tiered (b) at TIERED_TIMING_FRAMES frames per shard: every shard's
    lossless bucket (S * slots * W * (R + spec) assignments) coalesced
    over the frame buffer (the coalescing sees its page count)."""
    from repro_torch.core.backend import KernelBackend
    items = SHARDS * TIERED["slots"] * W * (DEGREE + TIERED["spec"])
    be = KernelBackend(coalesce_qb=QB)
    f = TIERED_TIMING_FRAMES
    qb = QB if be.coalesce_active(items, f) else 1
    return (SHARDS * be.distance_grid_steps(items, f), qb, PAGE, DIM,
            SHARDS * f)


# ---------------------------------------------------------------------------
# Phase 3: search kernels against their plain versions
# ---------------------------------------------------------------------------
def bf16_distance() -> dict:
    """The distance kernel's bf16 instantiations: {name: (queries dtype,
    store dtype)}."""
    from repro_torch.kernels.distance.kernel import KERNEL, KERNELS
    return {k.name: (q, d) for (q, d), k in KERNELS.items() if k is not KERNEL}


def dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.")


def as_dtypes(args, qt, dt):
    """A distance case with q cast to ``qt`` and the store to ``dt``; qq
    and vnorm are the self dots of the (exactly) upcast operands."""
    pid, q, _, db, _ = args
    q, db = q.to(qt), db.to(dt)
    return (pid, q, (q.float() ** 2).sum(-1), db, (db.float() ** 2).sum(-1))


def distance_case(T, QB, P, d, NP, dev, integer: bool, seed: int,
                  sort: bool = True):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if integer:
        q = torch.randint(-8, 9, (T, QB, d), generator=g, device=dev).float()
        db = torch.randint(-8, 9, (NP, P, d), generator=g, device=dev).float()
    else:
        q = torch.randn((T, QB, d), generator=g, device=dev)
        db = torch.randn((NP, P, d), generator=g, device=dev)
    pid = torch.randint(0, NP, (T,), generator=g, device=dev,
                        dtype=torch.int32)
    if sort:      # the dispatcher's order: runs of tiles share a page
        pid = torch.sort(pid).values
    return pid, q, (q * q).sum(-1), db, (db * db).sum(-1)


def check_distance(shapes: dict, dev) -> float:
    """The f32 kernel against its plain version; returns the worst max
    abs error."""
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    worst = 0.0
    for label, (T, QB, P, d, NP, sort) in shapes.items():
        for integer in (True, False):
            args = distance_case(T, QB, P, d, NP, dev, integer, seed=T + NP,
                                 sort=sort)
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
                  "store_mib": NP * P * d * 4 / 2**20, "page_sorted": sort,
                  "inputs": "integer" if integer else "real",
                  "max_abs_err": max_abs, "max_rel_err": max_rel,
                  "tolerance": "exact" if integer else f"rtol {RTOL_REAL}"})
            del args, out, ref, err
    return worst


def check_distance_bf16(shapes: dict, dev) -> dict:
    """Each bf16 instantiation against its plain version (exact on
    integer inputs, RTOL_REAL on real ones) and against the f32 kernel
    on the upcast operands (bit for bit); returns each one's worst max
    abs error against its plain version."""
    import torch
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    worst = {}
    for name, (qt, dt) in bf16_distance().items():
        worst[name] = 0.0
        for label, (T, QB, P, d, NP, sort) in shapes.items():
            for integer in (True, False):
                args = as_dtypes(distance_case(T, QB, P, d, NP, dev, integer,
                                               seed=T + NP, sort=sort), qt, dt)
                out = paged_distances(*args)
                ref = paged_distances_ref(*args)
                f32 = paged_distances(args[0], args[1].float(), args[2],
                                      args[3].float(), args[4])
                err = (out - ref).abs()
                max_abs = float(err.max())
                max_rel = float((err / ref.abs().clamp_min(1e-30)).max())
                if not torch.equal(out.view(torch.int32),
                                   f32.view(torch.int32)):
                    raise AssertionError(f"{name} {label}: differs from the "
                                         f"f32 kernel on upcast operands")
                if integer and max_abs != 0.0:
                    raise AssertionError(f"{name} {label}: integer-valued "
                                         f"inputs differ by {max_abs}")
                if not integer and max_rel > RTOL_REAL:
                    raise AssertionError(f"{name} {label}: relative error "
                                         f"{max_rel} > {RTOL_REAL}")
                worst[name] = max(worst[name], max_abs)
                emit({"phase": "kernels", "kernel": name, "case": label,
                      "queries": dtype_name(qt), "store": dtype_name(dt),
                      "T": T, "QB": QB, "P": P, "d": d, "NP": NP,
                      "store_mib": NP * P * d * dt.itemsize / 2**20,
                      "page_sorted": sort,
                      "inputs": "integer" if integer else "real",
                      "max_abs_err": max_abs, "max_rel_err": max_rel,
                      "equals_f32_kernel_on_upcast": True,
                      "tolerance": "exact" if integer
                      else f"rtol {RTOL_REAL}"})
                del args, out, ref, f32, err
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


def bits_equal(got, want) -> bool:
    """Every tensor equal bit for bit (floats by their bits: -0.0, NaN)."""
    import torch
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               if g.dtype == torch.float32 else torch.equal(g, w)
               for g, w in zip(got, want))


def gather_case(R, la, lb, dev, seed: int, special: bool = False):
    """The Gather merge's operands: sorted candidates with expanded flags
    and a sentinel tail; unsorted proposals with (dist, id) ties against
    the candidates (other payload), a duplicated proposal and invalid
    entries; row 0 all invalid, row 1 all valid; with ``special``, -0.0
    beside 0.0 on one id, NaN and inf."""
    import torch
    from repro_torch.kernels.topk import bitonic_sort_ref
    from repro_torch.utils import BIG_DIST, ID_SENTINEL
    g = torch.Generator(device=dev).manual_seed(seed)
    cd, ci, ce = bitonic_sort_ref(*sort_rows(R, la, dev, seed))
    ce = ce.bool()
    tail = la - la // 4
    cd[:, tail:], ci[:, tail:], ce[:, tail:] = BIG_DIST, ID_SENTINEL, False
    nd = torch.randint(0, 8, (R, lb), generator=g, device=dev).float()
    ni = torch.randint(0, la + lb, (R, lb), generator=g, device=dev).int()
    k = min(tail, lb)
    nd[:, :k:3], ni[:, :k:3] = cd[:, :k:3], ci[:, :k:3]
    if lb >= 3:
        nd[:, -1], ni[:, -1] = nd[:, 1], ni[:, 1]
    nv = torch.rand((R, lb), generator=g, device=dev) < 0.7
    nv[0], nv[1] = False, True
    if special and lb >= 4:
        nd[:, 0], nd[:, 1], ni[:, 1] = -0.0, 0.0, ni[:, 0]
        nd[:, 2], nd[:, 3] = float("nan"), float("inf")
    return cd, ci.contiguous(), ce, nd, ni, nv


def two_launch_merge(cd, ci, ce, nd, ni, nv, out_w):
    """The Gather merge as two cuda launches: bitonic_sort of the masked
    proposals, then bitonic_merge of A ++ filler ++ reversed(B)."""
    import torch
    from repro_torch.kernels.topk import merge_sorted_op, sort_op
    from repro_torch.utils import BIG_DIST, ID_SENTINEL
    sd, si = sort_op(torch.where(nv, nd, BIG_DIST),
                     torch.where(nv, ni, ID_SENTINEL), mode="cuda")
    d, i, e = merge_sorted_op(cd, ci, sd, si, (ce.int(),),
                              (torch.zeros_like(si),), mode="cuda")
    return d[:, :out_w], i[:, :out_w], e[:, :out_w] != 0


def lane_words(B, M, dev, seed: int, dtypes):
    """Payload lanes of random 32-bit words, one per dtype; the f32 ones
    carry two NaN payloads, -0.0 and 0.0 (moved as raw words)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for dt in dtypes:
        w = torch.randint(-2**31, 2**31 - 1, (B, M), generator=g,
                          device=dev, dtype=torch.int32)
        if dt == torch.float32:
            w[:, 0], w[:, 1] = -2**31, 0
            w[:, 2 % M], w[:, 3 % M] = 0x7fc00000, 0x7fc00123
        out.append(w.view(dt))
    return out


# phase kernels' payload-lane cases: the sort at B 2048 with M 32 and
# M 256 (register and shared bodies) and 3 lanes (i32, f32, i32), the
# merge pass at M 64 with 2 lanes; phase timing's 3-lane sort row
LANE_SORTS = ((2048, 32), (2048, 256))
LANE_MERGE = (2048, 64)


def check_lanes(dev) -> None:
    """The bitonic kernels with several payload lanes (positions through
    the network, an epilogue permuting every lane) bit for bit against
    their plain versions and their other body, with (dist, id) ties
    whose lanes differ, -0.0 / NaN / inf keys."""
    import torch
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref)
    from repro_torch.kernels.topk.kernel import MERGE_KERNEL, SORT_KERNEL
    i32, f32 = torch.int32, torch.float32
    cases = [(bitonic_sort, bitonic_sort_ref, SORT_KERNEL, B, M,
              (i32, f32, i32)) for B, M in LANE_SORTS]
    cases.append((bitonic_merge, bitonic_merge_ref, MERGE_KERNEL,
                  *LANE_MERGE, (i32, f32)))
    for kernel, plain, handle, B, M, dtypes in cases:
        d, i, _ = sort_rows(B, M, dev, seed=M + 1)
        i = i % (M // 4)                          # ties, lanes differ
        d[:, 0], d[:, 1], i[:, 1] = -0.0, 0.0, i[:, 0]
        d[:, 2], d[:, 3] = float("nan"), float("inf")
        lanes = lane_words(B, M, dev, seed=M, dtypes=dtypes)
        if kernel is bitonic_merge:
            d, i, *lanes = bitonic_sort_ref(d, i, *lanes)
            h = M // 2
            d, i, *lanes = (torch.cat([x[:, :h], x[:, h:].flip(1)], 1)
                            for x in (d, i, *lanes))
        before = handle.launches
        got = kernel(d, i, *lanes)
        launched = handle.launches - before
        checks = {"plain": plain(d, i, *lanes),
                  "shared_body": kernel(d, i, *lanes, shared=True)}
        for what, want in checks.items():
            if not bits_equal(got, want):
                raise AssertionError(f"{handle.name} B={B} M={M} lanes "
                                     f"{dtypes}: differs from {what}")
        emit({"phase": "kernels", "kernel": handle.name, "B": B, "M": M,
              "payload_lanes": [str(t).split(".")[-1] for t in dtypes],
              "launches": launched, "held_against": sorted(checks),
              "special_values": True, "max_abs_err": 0.0,
              "tolerance": "exact (bits)"})
        if launched != 1:
            raise AssertionError(f"{handle.name}: {launched} launches for "
                                 f"{len(dtypes)} lanes")


def check_topk(dev) -> float:
    import torch
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref,
                                          merge_unsorted, merge_unsorted_ref)
    for kernel, plain, label in ((bitonic_sort, bitonic_sort_ref,
                                  "bitonic_sort"),
                                 (bitonic_merge, bitonic_merge_ref,
                                  "bitonic_merge")):
        for (B, M), special in itertools.product(
                ((256, 16), (256, 64), (7, 128), (7, 2048), (5, 1),
                 ROUTE_SORT, FUSE_MERGE), (False, True)):
            d, i, p = sort_rows(B, M, dev, seed=M)
            if special and M >= 4:   # -0.0 beside 0.0 on one id, NaN, inf
                d[:, 0], d[:, 1], i[:, 1] = -0.0, 0.0, i[:, 0]
                d[:, 2], d[:, 3] = float("nan"), float("inf")
            if kernel is bitonic_merge:     # make each row bitonic
                d, i, p = bitonic_sort_ref(d, i, p)
                h = M // 2
                d, i, p = (torch.cat([x[:, :h], x[:, h:].flip(1)], 1)
                           for x in (d, i, p))
            for lanes in ((p,), ()):
                got = kernel(d, i, *lanes)
                if not bits_equal(got, plain(d, i, *lanes)) or \
                        not bits_equal(got, kernel(d, i, *lanes, shared=True)):
                    raise AssertionError(f"{label} B={B} M={M} special="
                                         f"{special}: kernel differs from "
                                         f"plain version or from its "
                                         f"shared-memory body")
            emit({"phase": "kernels", "kernel": label, "B": B, "M": M,
                  "special_values": special, "payload_lanes": [1, 0],
                  "bodies": ["auto", "shared"], "max_abs_err": 0.0,
                  "tolerance": "exact (bits)"})
    # the Gather merge: path shape, ragged row counts, non-power-of-two
    # widths, the register body's widest rows and the shared body's
    for R, la, lb in ((GATHER["R"], GATHER["LA"], GATHER["LB"]),
                      (GATHER["R"], GATHER["LA"], GATHER["LB_SPEC"]),
                      (255, 10, 6), (129, 13, 10), (64, 100, 28),
                      (33, 3, 29), (9, 1500, 548), (4, 1024, 1024)):
        for special in (False, True):
            case = gather_case(R, la, lb, dev, seed=la + lb, special=special)
            for out_w in sorted({la, la + lb, max(1, la // 2)}):
                got = merge_unsorted(*case, out_w)
                checks = {"two_launch": two_launch_merge(*case, out_w),
                          "shared_body": merge_unsorted(*case, out_w,
                                                        shared=True),
                          "plain": merge_unsorted_ref(*case, out_w)}
                for what, want in checks.items():
                    if not bits_equal(got, want):
                        raise AssertionError(
                            f"merge_unsorted R={R} LA={la} LB={lb} "
                            f"out_w={out_w} special={special}: differs "
                            f"from {what}")
            emit({"phase": "kernels", "kernel": "bitonic_merge_unsorted",
                  "R": R, "LA": la, "LB": lb, "special_values": special,
                  "held_against": sorted(checks), "max_abs_err": 0.0,
                  "tolerance": "exact (bits)"})
    check_lanes(dev)
    return 0.0


# ---------------------------------------------------------------------------
# Phases 5 and 6: the search main path
# ---------------------------------------------------------------------------
def capture_line(stats, live_rounds: int, syncs: int) -> dict:
    """The capture cache's counters over one run: captures, replays, the
    rounds the device ran (the captures' eager warm-up rounds and every
    replay's K masked rounds), and how many of the replayed rounds were
    dead (past the loop's exit), beside the run's host syncs."""
    return {"captures": stats.captures, "replays": stats.replays,
            "device_rounds": stats.rounds, "warm_rounds": stats.warm_rounds,
            "dead_rounds": stats.rounds - stats.warm_rounds - live_rounds,
            "host_syncs": syncs}


def idle_share(prof, wall_ms: float):
    """(device busy ms, idle share of ``wall_ms``) from a torch.profiler
    run over device activity."""
    busy_ms = sum(us for us, _ in device_kernel_us(prof).values()) / 1e3
    return busy_ms, 1.0 - busy_ms / wall_ms


def check_launches(what: str, launches: dict, device_rounds: int) -> None:
    """Every round the device ran launched the distance kernel and the
    fused Gather merge once each, the standalone sort and merge never."""
    if launches["paged_distance"] != device_rounds or \
            launches["bitonic_merge_unsorted"] != device_rounds or \
            launches["bitonic_sort"] or launches["bitonic_merge"]:
        raise AssertionError(f"{what}: {device_rounds} rounds on the "
                             f"device, launches {launches}")


def integer_main_path(dev):
    """Returns the index and queries, for phase 7."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (SEARCH_CHUNK, EngineParams,
                                         pack_for_engine, search_sim)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.launch.search import build_index

    rng = np.random.default_rng(0)
    n, dim, shards, nq = 2048, 32, 8, 256
    db = rng.integers(-8, 9, size=(n, dim)).astype(np.float32)
    queries = rng.integers(-8, 9, size=(nq, dim)).astype(np.float32)
    t0 = time.perf_counter()
    db_r, packed = build_index(db, shards=shards, page_size=64, r=16,
                               pref_width=8)
    build_s = time.perf_counter() - t0
    qsh = queries.reshape(shards, nq // shards, dim)
    out, syncs = {}, {}
    for name, mode, where, capture in (
            ("captured", "cuda", dev, True),
            ("uncaptured", "cuda", dev, False),
            ("ref", "ref", torch.device("cpu"), True)):
        params = EngineParams.lossless(SearchParams(L=32, W=1, k=10),
                                       nq // shards, 16, kernel_mode=mode)
        consts, geom, entry = pack_for_engine(packed, device=where)
        CACHE.reset_stats()
        ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                    device=where, capture=capture)
        syncs[name] = st.pop("host_syncs")
        out[name] = {"ids": ids.cpu(), "dists": dists.cpu().view(torch.int32),
                     **{k: v.cpu() for k, v in st.items()}}
        if name == "captured":
            cap = capture_line(CACHE.stats,
                               int(st["total_rounds"].max()), syncs[name])
            captured = (params, consts, geom, entry)
    for name in ("captured", "uncaptured"):
        for key, want in out["ref"].items():
            if not torch.equal(out[name][key], want):
                raise AssertionError(f"integer main path: {name} cuda-mode "
                                     f"{key} differs from CPU ref mode")
    rounds = int(out["ref"]["total_rounds"].max())
    if syncs["captured"] != -(-rounds // SEARCH_CHUNK):
        raise AssertionError(f"integer main path: {syncs['captured']} host "
                             f"syncs for {rounds} rounds")
    # one more captured search (replays only), timed, then profiled
    params, consts, geom, entry = captured
    qdev = torch.as_tensor(qsh, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    search_sim(consts, qdev, *entry, params, geom, device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        search_sim(consts, qdev, *entry, params, geom, device=dev)
        torch.cuda.synchronize()
    busy_ms, idle = idle_share(prof, wall_ms)
    del prof
    drop_traces()
    emit({"phase": "int", "n": n, "d": dim, "shards": shards, "queries": nq,
          "host_build_s": round(build_s, 2), "rounds": rounds,
          "search_chunk": SEARCH_CHUNK, **cap,
          "host_ms_per_round": wall_ms / rounds,
          "device_busy_ms": busy_ms, "device_idle_share": idle,
          "bit_identical": {"captured_vs_uncaptured_vs_cpu_ref":
                            sorted(out["ref"])}})
    traversal_integer(db_r, packed, queries, dev)
    return packed, queries, db


def flat_adjacency(packed):
    """(n, R) adjacency in vertex-id order from a packed index."""
    import numpy as np
    g, n = packed.geometry, packed.n
    ids = np.arange(n, dtype=np.int64)
    lslot = g.local_page_of_n(ids, n) * g.page_size + ids % g.page_size
    return packed.adj[g.owner_of_n(ids, n), lslot]


def traversal_integer(db, packed, queries, dev) -> None:
    """traversal.search (one shard, the host's round loop) in cuda mode
    on the card against ref mode on the CPU, bit for bit, with its launch
    counts."""
    import torch
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.traversal import search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    adj = flat_adjacency(packed)
    vnorm = (db * db).sum(-1)
    sp = SearchParams(L=32, W=1, k=10)
    out = {}
    for mode, where in (("cuda", dev), ("ref", "cpu")):
        reset_launch_counts()
        ids, dists, st = search(db, adj, vnorm, queries, packed.entry, sp,
                                page_size=PAGE, kernel_mode=mode,
                                device=where)
        out[mode] = {"ids": ids.cpu(), "dists": dists.cpu().view(
            torch.int32), **{k: torch.as_tensor(v).cpu()
                             for k, v in st.items()}}
        if mode == "cuda":
            launches = {k: v for k, v in launch_counts().items() if v}
    rounds = int(out["ref"]["total_rounds"])
    emit({"phase": "int", "search": "traversal.search", "rounds": rounds,
          "launches": launches, "bit_identical_to_cpu_ref": sorted(
              k for k in out["ref"] if torch.equal(out["cuda"][k],
                                                   out["ref"][k]))})
    for key, want in out["ref"].items():
        if not torch.equal(out["cuda"][key], want):
            raise AssertionError(f"traversal.search: cuda-mode {key} "
                                 f"differs from CPU ref mode")
    if launches.get("paged_distance") != rounds or \
            launches.get("bitonic_merge_unsorted") != rounds:
        raise AssertionError(f"traversal.search: {rounds} rounds, launches "
                             f"{launches}")


# phase main's standing counts (recall@k equals the reference's)
MAIN_COUNTS = {"recall@k": REFERENCE_RECALL, "rounds": 98,
               "pages_unique": 11337, "items_recv": 71738}
# measured repeats of the main path (its QPS spread within one process)
REPEATS = 5


def build_main_sift():
    """The sift-1b stand-in's search build on the host, with prefetch
    lists of 8: (reordered vectors, packed index, host seconds). Run in a
    child process (``spawn``) while the integer phases use the card."""
    from repro_torch.launch.search import build_index, dataset
    ds = dataset("sift-1b")
    assert (ds.n, ds.dim) == (N, DIM)
    t0 = time.perf_counter()
    db, packed = build_index(ds.materialize(), shards=SHARDS, page_size=PAGE,
                             r=DEGREE, pref_width=8)
    return db, packed, time.perf_counter() - t0


def real_main_path(dev, built):
    """Returns the kernels' launch counts, and the build for phase 7
    (``built``: the async result of :func:`build_main_sift`)."""
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset, run_search

    ds = dataset("sift-1b")
    queries = ds.queries(NQ, seed=1)
    t0 = time.perf_counter()
    db, packed, build_s = built.get()
    wait_s = time.perf_counter() - t0
    cfg = dict(shards=SHARDS, L=L, W=W, k=K, spec=0, kernel_mode="auto",
               coalesce_qb=QB, device=dev)
    engine = pack_for_engine(packed, device=dev)
    t0 = time.perf_counter()
    run_search(engine, db, queries, **cfg)     # warm-up: builds the capture
    warm_s = time.perf_counter() - t0
    reset_launch_counts()
    CACHE.reset_stats()
    res = run_search(engine, db, queries, **cfg)
    launches = launch_counts()
    cap = capture_line(CACHE.stats, res["rounds"], res["host_syncs"])
    qps = [run_search(engine, db, queries, **cfg)["qps"]
           for _ in range(REPEATS)]
    res.update(dataset=ds.name, host_build_s=round(build_s, 2),
               host_build_wait_s=round(wait_s, 2), warmup_s=warm_s,
               qps_repeats=qps, **cap,
               host_ms_per_round=res["search_s"] * 1e3 / res["rounds"],
               launches=launches,
               launches_per_device_round={
                   k: v / cap["device_rounds"] for k, v in launches.items()})
    # the same search run eagerly on the card, outside the cache
    consts, geom, entry = engine
    params = EngineParams.lossless(SearchParams(L=L, W=W, k=K),
                                   NQ // SHARDS, DEGREE, coalesce_qb=QB)
    qsh = torch.as_tensor(queries.reshape(SHARDS, NQ // SHARDS, -1),
                          device=dev)
    got = {}
    for capture in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i, d, st = search_sim(consts, qsh, *entry, params, geom, device=dev,
                              capture=capture)
        i = i.cpu()
        got[capture] = (time.perf_counter() - t0, i, d.cpu().view(
            torch.int32), {k: v.cpu() for k, v in st.items()
                           if k != "host_syncs"})
    res["uncaptured_qps"] = NQ / got[False][0]
    same = [torch.equal(a, b) for a, b in zip(got[True][1:3],
                                               got[False][1:3])]
    same += [torch.equal(got[True][3][k], got[False][3][k])
             for k in got[True][3]]
    res["captured_equals_uncaptured"] = all(same)
    emit({"phase": "main", **res})
    if not all(same):
        raise AssertionError("main path: the captured search differs from "
                             "the uncaptured one")
    if not all(launches[k] > 0 for k in SEARCH_KERNELS):
        raise AssertionError(f"a kernel did not launch on the main path: "
                             f"{launches}")
    check_launches("main path", launches, cap["device_rounds"])
    if cap["captures"] or cap["replays"] != res["host_syncs"]:
        raise AssertionError(f"main path: a warm search must replay its "
                             f"capture once per chunk: {cap}")
    for key, want in MAIN_COUNTS.items():
        if res[key] != want:
            raise AssertionError(f"main path: {key} {res[key]}, not {want}")
    if not math.isfinite(res["mean_dists_per_query"]):
        raise AssertionError("non-finite distance count")
    profile_main_path(consts, geom, entry, params, qsh, res["search_s"], dev)
    drop_traces()
    return launches, (db, packed), dict(
        engine=engine, queries=queries, ids=got[True][1],
        dists=got[True][2].view(torch.float32), res=res)


def profile_main_path(consts, geom, entry, params, qsh, wall_s: float,
                      dev) -> None:
    """One more (captured) search_sim call under torch.profiler (device
    activity only): the card's kernel time by name, and its busy share
    of the unprofiled call's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.engine import search_sim

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, st = search_sim(consts, qsh, *entry, params, geom, device=dev)
        torch.cuda.synchronize()
    kern = device_kernel_us(prof)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    ours = {"paged_distance": "paged_distance_kernel",
            "bitonic_merge_unsorted": "merge_unsorted_",
            "bitonic_sort|merge": "bitonic_"}
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
# Phase engine_variants: the engine's static variants and fault plans
# ---------------------------------------------------------------------------
def exchange_bytes(engine, queries, params, items_per_round: float) -> dict:
    """Modelled bytes of one round's simulated exchange, from the bucket
    tensors one eager round hands to it (``exchange_buckets``):
    ``dense``, every bucket of the four exchanges (static shapes, at any
    occupancy), and ``phase_cd_sent``, phases C and D's bytes per bucket
    slot times the ``items_per_round`` slots actually filled (ids and
    query payloads out, scalar distances back for NDP, whole vectors
    back for the gather_vectors baseline). On one card the exchange is a
    view, so neither is a count of bytes copied."""
    from repro_torch.core.engine import exchange_buckets
    consts, geom, entry = engine
    ex = exchange_buckets(consts, queries, *entry, params, geom)
    return {"dense": sum(e["bytes"] for e in ex),
            "phase_cd_sent": items_per_round * sum(
                e["bytes"] / e["slots"] for e in ex[2:])}


def engine_variants_integer(packed, queries, dev) -> None:
    """On phase int's integer index: search_sim captured on the card in
    cuda mode with gather_vectors, with payload_bf16 and after a block
    refresh (frac 0.5), and stream_search with a delay plan, a kill plan
    under a deadline, page corruption ("neg", 0.08) with the guard and
    NaN corruption without it: each equal to CPU ref mode bit for bit,
    with its launch accounting (the fused merge sorts a NaN proposal
    after every number, as the plain version does)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.refresh import refresh_blocks
    from repro_torch.core.scheduler import stream_search
    from repro_torch.ft.inject import fault_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    shards, nq = SHARDS, len(queries)
    qsh = queries.reshape(shards, nq // shards, -1)
    refreshed = refresh_blocks(packed, np.random.default_rng(42), frac=0.5)
    sp = SearchParams(L=32, W=1, k=10)
    searches = {"gather_vectors": (packed, dict(gather_vectors=True)),
                "payload_bf16": (packed, dict(payload_bf16=True)),
                "refresh_frac_0.5": (refreshed, {}),
                "ndp": (packed, {})}
    found = {}
    for name, (index, kw) in searches.items():
        out = {}
        for where, mode in ((dev, "cuda"), (torch.device("cpu"), "ref")):
            params = EngineParams.lossless(sp, nq // shards, 16,
                                           kernel_mode=mode, **kw)
            consts, geom, entry = pack_for_engine(index, device=where)
            reset_launch_counts()
            CACHE.reset_stats()
            ids, dists, st = search_sim(consts, qsh, *entry, params, geom,
                                        device=where)
            launches = launch_counts()
            out[mode] = {"ids": ids.cpu(), "dists": dists.cpu().view(
                torch.int32), **{k: v.cpu() for k, v in st.items()
                                 if k != "host_syncs"}}
            if mode == "cuda":
                rounds = CACHE.stats.rounds
                cuda_launches = launches
        for key, want in out["ref"].items():
            if not torch.equal(out["cuda"][key], want):
                raise AssertionError(f"engine variant {name}: cuda-mode "
                                     f"{key} differs from CPU ref mode")
        dist = {k: v for k, v in cuda_launches.items()
                if k.startswith("paged_distance") and v}
        want_dist = {"gather_vectors": {},
                     "payload_bf16": {"paged_distance_bf16q": rounds}}.get(
            name, {"paged_distance": rounds})
        if dist != want_dist or \
                cuda_launches["bitonic_merge_unsorted"] != rounds:
            raise AssertionError(f"engine variant {name}: {rounds} device "
                                 f"rounds, launches {cuda_launches}")
        found[name] = out["ref"]
        emit({"phase": "engine_variants", "index": "integer", "run": name,
              "search": "search_sim", "rounds": int(
                  out["ref"]["total_rounds"].max()), "device_rounds": rounds,
              "launches": {k: v for k, v in cuda_launches.items() if v},
              "bit_identical_to_cpu_ref": sorted(out["ref"])})
    for name in ("gather_vectors", "payload_bf16", "refresh_frac_0.5"):
        for key in ("ids", "dists", "rounds", "n_dist"):
            if not torch.equal(found[name][key], found["ndp"][key]):
                raise AssertionError(f"engine variant {name}: {key} "
                                     f"differs from NDP's")

    arrivals = np.random.default_rng(3).integers(0, 64, nq)
    dl = 60
    plans = {"delay": (fault_plan(shards).delay(0, 4, 6).delay(5, 10, 3),
                       {}),
             "kill": (fault_plan(shards).kill(2, 6), {"deadline_rounds": dl}),
             "corrupt_neg_guarded": (fault_plan(shards).corrupt(
                 0.08, "neg", seed=3), {"guard_nonfinite": True}),
             "corrupt_nan_unguarded": (fault_plan(shards).corrupt(
                 0.08, "nan", seed=3), {})}
    for name, (faults, kw) in plans.items():
        out = {}
        for where, mode in ((dev, "cuda"), (torch.device("cpu"), "ref")):
            params = dataclasses.replace(EngineParams.lossless(
                sp, 8, 16, kernel_mode=mode, faults=faults), **kw)
            consts, geom, entry = pack_for_engine(packed, device=where)
            _, _, st = stream_search(consts, geom, params, entry, queries,
                                     num_slots=8, arrivals=arrivals,
                                     round_chunk=8, device=where)
            out[mode] = (stream_records(st, nq) | {
                "stall_rounds": per_query(st, nq, "stall_rounds")},
                {"quarantined": st.quarantined, "truncated": st.truncated,
                 "stalls": st.stalls, "total_rounds": st.total_rounds})
        differ = first_difference(out["cuda"][0], out["ref"][0])
        same = differ is None and out["cuda"][1] == out["ref"][1]
        emit({"phase": "engine_variants", "index": "integer", "run": name,
              "search": "stream_search", "queries": nq, "slots_per_shard": 8,
              **out["ref"][1], "cuda_equals_cpu_ref": same,
              "first_difference": differ})
        if not same:
            raise AssertionError(f"fault plan {name}: the card's stream "
                                 f"differs from CPU ref mode ({differ}, "
                                 f"{out['cuda'][1]} vs {out['ref'][1]})")
        if (name == "corrupt_neg_guarded" and not out["ref"][1]["quarantined"]
                or name == "kill" and not out["ref"][1]["truncated"]
                or name == "delay" and not out["ref"][1]["stalls"]):
            raise AssertionError(f"fault plan {name} did not bite: "
                                 f"{out['ref'][1]}")


def engine_variants_sift(main: dict, dev) -> dict:
    """On phase main's sift-1b build: search_sim with gather_vectors and
    with payload_bf16 beside NDP (phase main's numbers): recall@k,
    rounds, items_recv, QPS (REPEATS calls) and the modelled bucket bytes
    of the exchange per round. The baseline must return NDP's ids, bf16 payloads keep recall
    within RECALL_TOL. Returns each run's launch counts (zeroed just
    before its measured call, read just after)."""
    import dataclasses

    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, search_sim
    from repro_torch.core.graph import brute_force_topk, recall_at_k
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.traversal import gather_baseline_bytes
    from repro_torch.kernels import launch_counts, reset_launch_counts

    consts, geom, entry = main["engine"]
    queries, ndp = main["queries"], main["res"]
    qsh = torch.as_tensor(queries.reshape(SHARDS, NQ // SHARDS, -1),
                          device=dev)
    true_ids, _ = brute_force_topk(main["db"], queries, K)
    base = EngineParams.lossless(SearchParams(L=L, W=W, k=K), NQ // SHARDS,
                                 DEGREE, coalesce_qb=QB)

    def timed(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        i, d, st = search_sim(consts, qsh, *entry, params, geom, device=dev)
        i = i.cpu()
        return time.perf_counter() - t0, i, st, d.cpu()

    per_round = ndp["items_recv"] / ndp["rounds"]
    out = {"ndp": {"recall@k": ndp["recall@k"], "rounds": ndp["rounds"],
                   "items_recv": ndp["items_recv"], "qps": ndp["qps"],
                   "qps_repeats": ndp["qps_repeats"],
                   "modelled_bucket_bytes_per_round": exchange_bytes(
                       main["engine"], qsh, base, per_round)}}
    launches = {}
    for name in ("gather_vectors", "payload_bf16"):
        params = dataclasses.replace(base, **{name: True})
        timed(params)                                # warm-up: the capture
        reset_launch_counts()
        CACHE.reset_stats()
        wall, ids, st, dists = timed(params)
        launches[name] = launch_counts()
        device_rounds = CACHE.stats.rounds
        rounds = int(st["total_rounds"].max())
        items = int(st["items_recv"].sum())
        qps = [NQ / timed(params)[0] for _ in range(REPEATS)]
        flat = ids.reshape(NQ, -1).numpy()
        out[name] = {
            "recall@k": round(float(recall_at_k(flat, true_ids)), 4),
            "rounds": rounds, "items_recv": items,
            "pages_unique": int(st["pages_unique"].sum()),
            "qps": NQ / wall, "qps_repeats": qps,
            "device_rounds": device_rounds,
            "launches": {k: v for k, v in launches[name].items() if v},
            "modelled_bucket_bytes_per_round": exchange_bytes(
                main["engine"], qsh, params, items / rounds)}
        if name == "gather_vectors":
            # the baseline's dot is a torch sum over d, the kernel's a
            # sequential FMA chain: ids may differ only in a near-tie
            rows = (ids != main["ids"]).reshape(NQ, -1).any(1)
            near = (dists - main["dists"]).abs() <= \
                NEAR_TIE * main["dists"].abs() + NEAR_TIE
            out[name]["ids_differ_from_ndp_rows"] = \
                rows.nonzero().flatten().tolist()
            out[name]["ids_equal_ndp_up_to_near_ties"] = bool(
                near.reshape(NQ, -1)[rows].all())
    emit({"phase": "engine_variants", "index": "sift-1b", **out,
          "napkin_bytes_per_expansion": gather_baseline_bytes(
              SearchParams(L=L, W=W, k=K), DIM, R=DEGREE)})
    if not out["gather_vectors"]["ids_equal_ndp_up_to_near_ties"]:
        raise AssertionError("gather_vectors: ids differ from NDP's beyond "
                             "a distance near-tie")
    if abs(out["payload_bf16"]["recall@k"] - ndp["recall@k"]) > RECALL_TOL:
        raise AssertionError(f"payload_bf16 moved recall by more than "
                             f"{RECALL_TOL}: {out['payload_bf16']}")
    gv = launches["gather_vectors"]
    rounds = out["gather_vectors"]["device_rounds"]
    if any(gv[k] for k in gv if k.startswith("paged_distance")) or \
            gv["bitonic_merge_unsorted"] != rounds:
        raise AssertionError(f"gather_vectors launched {gv} over {rounds} "
                             f"device rounds")
    bf = launches["payload_bf16"]
    if bf["paged_distance_bf16q"] != out["payload_bf16"]["device_rounds"] \
            or bf["paged_distance"]:
        raise AssertionError(f"payload_bf16 launched {bf}")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the streaming scheduler
# ---------------------------------------------------------------------------
# (b)'s traffic: sift-1b queries, Poisson arrivals, a 256-row pool (the
# size of phase main's batch), round chunk 8, speculation width 4
STREAM = dict(queries=2048, slots=32, rate=8.0, chunk=8, spec=4,
              window=512, host_window=128)
STREAM_RUNS = {"refill_static": dict(refill=True, dynamic_spec=False),
               "refill_dynamic": dict(refill=True, dynamic_spec=True),
               "frozen_static": dict(refill=False, dynamic_spec=False)}
# real-valued ids may differ from one-shot search_sim's only where two
# distances tie within f32 rounding
NEAR_TIE = 1e-5
# the refill static run's standing schedule
STATIC_ROUNDS = 417
# the uncaptured twin of each stream session: the stream's first 512
# queries (cut from all 2048: the eager session of all of them ran
# 4.7-10.7 s on the card), against the same 512 captured
TWIN_QUERIES = 512
# sessions repeated for the QPS spread (5 before the cut)
STREAM_REPEATS = 3


def per_query(st, n: int, field: str):
    """A QueryResult field as an (n,) array in query order."""
    import numpy as np
    out = np.zeros(n, np.int64)
    for r in st.results:
        out[r.qid] = getattr(r, field)
    return out


def stream_records(st, n: int) -> dict:
    """Every per-query record but its wall time, in query order."""
    import numpy as np
    return {f: per_query(st, n, f) for f in (
        "arrival_round", "admit_round", "retire_round", "service_rounds",
        "n_dist", "truncated")} | {
        "ids": np.stack([r.ids for r in sorted(st.results,
                                               key=lambda r: r.qid)]),
        "dists": np.stack([r.dists for r in sorted(
            st.results, key=lambda r: r.qid)]).view(np.int32)}


def first_difference(got: dict, want: dict):
    import numpy as np
    return next((k for k in want if not np.array_equal(got[k], want[k])),
                None)


def stream_integer(packed, queries, dev) -> None:
    """(a) On phase int's integer index: stream_search in cuda mode on the
    card, captured, equals the same stream uncaptured on the card, in ref
    mode on the CPU, and one-shot search_sim in cuda mode on the same
    queries, in ids, dists, rounds and n_dist (and every per-query
    record against the other streams); refill, in-device admission,
    round chunk 8, random arrivals."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import stream_search

    nq, slots = len(queries), 8
    arrivals = np.random.default_rng(3).integers(0, 64, nq)
    sp = SearchParams(L=32, W=1, k=10)
    for spec in (0, 4):
        out = {}
        for name, mode, where, capture in (
                ("captured", "cuda", dev, True),
                ("uncaptured", "cuda", dev, False),
                ("ref", "ref", torch.device("cpu"), True)):
            params = EngineParams.lossless(sp, slots, 16, spec_width=spec,
                                           kernel_mode=mode)
            consts, geom, entry = pack_for_engine(packed, device=where)
            CACHE.reset_stats()
            _, _, st = stream_search(
                consts, geom, params, entry, queries, num_slots=slots,
                arrivals=arrivals, round_chunk=8, injit_admit=True,
                device=where, capture=capture)
            out[name] = stream_records(st, nq)
            if name == "captured":
                stats, cuda_build = st, (consts, geom, entry)
                cap = capture_line(CACHE.stats,
                                   st.total_rounds + st.warmup_rounds,
                                   st.host_syncs)
        consts, geom, entry = cuda_build
        params = EngineParams.lossless(sp, nq // SHARDS, 16, spec_width=spec,
                                       kernel_mode="cuda")
        i, d, st1 = search_sim(consts, queries.reshape(SHARDS, nq // SHARDS,
                                                       -1),
                               *entry, params, geom, device=dev)
        oneshot = {"ids": i.reshape(nq, -1).cpu().numpy(),
                   "dists": d.reshape(nq, -1).cpu().numpy().view(np.int32),
                   "service_rounds": st1["rounds"].reshape(nq).cpu().numpy(),
                   "n_dist": st1["n_dist"].reshape(nq).cpu().numpy()}
        for other, want in (("uncaptured", out["uncaptured"]),
                            ("ref", out["ref"]), ("oneshot", oneshot)):
            key = first_difference(out["captured"], want)
            if key is not None:
                raise AssertionError(f"integer stream, spec {spec}: the "
                                     f"captured stream's {key} differs "
                                     f"from {other}")
        if stats.host_syncs != stats.host_dispatches or cap["captures"] != 1:
            raise AssertionError(f"integer stream, spec {spec}: one read "
                                 f"per chunk and one capture expected: "
                                 f"{cap}, {stats.host_dispatches} chunks")
        params = EngineParams.lossless(sp, slots, 16, spec_width=spec,
                                       kernel_mode="cuda")
        prof, _, wall_ms, window = profiled_session(
            lambda m: stream_search(consts, geom, params, entry,
                                    queries[:m], num_slots=slots,
                                    arrivals=arrivals[:m], round_chunk=8,
                                    injit_admit=True, device=dev)[2],
            nq, [ProfilerActivity.CUDA])
        busy_ms, idle = idle_share(prof, wall_ms)
        del prof
        drop_traces()
        emit({"phase": "stream_int", "spec": spec, "queries": nq,
              "slots_per_shard": slots, "total_rounds": stats.total_rounds,
              "warmup_rounds": stats.warmup_rounds,
              "host_dispatches": stats.host_dispatches, **cap,
              "host_ms_per_round": stats.wall_s * 1e3 / stats.total_rounds,
              "profiled_session": {**window, "wall_ms": wall_ms,
                                   "device_busy_ms": busy_ms,
                                   "device_idle_share": idle},
              "bit_identical": {"uncaptured_and_cpu_ref_streams":
                                sorted(out["ref"]),
                                "cuda_oneshot_search_sim": sorted(oneshot)}})


def profiled_session(run, n: int, activities):
    """(profiler, stats, wall ms, capture line) of ``run(n)`` under
    torch.profiler. An unprofiled ``run(n)`` first captures the
    session's chunk program; a profiled session that captured anyway
    (its staged queue landed at another address, a new cache key) is
    run again, at most three times, so the window holds replays only
    when it can."""
    import torch
    from torch.profiler import profile
    from repro_torch.core.capture import CACHE
    run(n)
    for attempt in range(1, 4):
        torch.cuda.synchronize()
        CACHE.reset_stats()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            st = run(n)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if CACHE.stats.captures == 0:
            break
    live = st.total_rounds + st.warmup_rounds
    return prof, st, wall_ms, {"attempts": attempt, **capture_line(
        CACHE.stats, live, st.host_syncs)}


def profile_stream_window(run, host: bool) -> dict:
    """stream_search calls under torch.profiler (``run(n)``: the run's
    configuration on the first n queries; :func:`profiled_session`).
    Device activity only, over STREAM["window"] queries: the card's
    kernel time and its share of the call's wall time. With ``host``,
    host and device activity over STREAM["host_window"] queries: per
    engine round, the host time inside torch ops (their self CPU time)
    against the wall time, the kernel and graph launches and the host's
    waits and copies (CUDA runtime calls), and the torch ops that take
    the most host time."""
    from torch.profiler import ProfilerActivity
    prof, st, wall_ms, cap = profiled_session(
        run, STREAM["window"], [ProfilerActivity.CUDA])
    kern = device_kernel_us(prof)
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    out = {"queries": STREAM["window"],
           "rounds": st.total_rounds + st.warmup_rounds, **cap,
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "device_ops": sum(c for _, c in kern.values())}
    if not host:
        return out
    prof, st, wall_ms, cap = profiled_session(
        run, STREAM["host_window"],
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    ev = prof.key_averages()
    rounds = st.total_rounds + st.warmup_rounds
    runtime = {e.key: e.count / rounds for e in ev if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
        "cudaStreamSynchronize", "cudaMemcpyAsync",
        "cudaDeviceSynchronize")}
    ops = [e for e in ev if e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: -e.self_cpu_time_total)[:8]
    out["host"] = {
        "queries": STREAM["host_window"], "rounds": rounds, **cap,
        "wall_ms_per_round": wall_ms / rounds,
        "aten_self_cpu_ms_per_round": sum(
            e.self_cpu_time_total for e in ops) / 1e3 / rounds,
        "aten_calls_per_round": sum(e.count for e in ops) / rounds,
        "runtime_calls_per_round": runtime,
        "top": [{"name": e.key, "self_cpu_ms_per_round":
                 e.self_cpu_time_total / 1e3 / rounds,
                 "calls_per_round": e.count / rounds} for e in top]}
    return out


def stream_path(db, packed, dev):
    """(b) The sift-1b stand-in served as an open-loop stream: three
    runs (refill static, refill dynamic, frozen), each checked against
    its own launch counts, the static one against one-shot search_sim.
    Returns the refill static session's (ids, dists, stats), which phase
    live's zero-churn session must equal."""
    import numpy as np
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_sim)
    from repro_torch.core.graph import brute_force_topk, recall_at_k
    from repro_torch.core.metrics import stream_summary
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import poisson_arrivals, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset

    nq, slots = STREAM["queries"], STREAM["slots"]
    queries = dataset("sift-1b").queries(nq, seed=1)
    arrivals = poisson_arrivals(STREAM["rate"], nq, seed=0)
    true_ids, _ = brute_force_topk(db, queries, K)
    consts, geom, entry = pack_for_engine(packed, device=dev)
    params = EngineParams.lossless(SearchParams(L=L, W=W, k=K), slots,
                                   DEGREE, spec_width=STREAM["spec"],
                                   coalesce_qb=QB)
    # one-shot search_sim on the same queries, in batches of the pool
    pool = SHARDS * slots
    t0 = time.perf_counter()
    shot_i, shot_d, shot_rounds = [], [], 0
    for b in range(0, nq, pool):
        i, d, st = search_sim(consts,
                              queries[b:b + pool].reshape(SHARDS, slots, -1),
                              *entry, params, geom, device=dev)
        shot_i.append(i.reshape(pool, -1).cpu().numpy())
        shot_d.append(d.reshape(pool, -1).cpu().numpy())
        shot_rounds += int(st["total_rounds"][0])
    shot_i, shot_d = np.concatenate(shot_i), np.concatenate(shot_d)
    oneshot_s = time.perf_counter() - t0

    def serve(kw, n=nq, capture=True):
        return stream_search(consts, geom, params, entry, queries[:n],
                             num_slots=slots, arrivals=arrivals[:n],
                             round_chunk=STREAM["chunk"], injit_admit=True,
                             device=dev, capture=capture, **kw)

    res = {}
    for name, kw in STREAM_RUNS.items():
        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = serve(kw)
        if name == "refill_static":
            static = (ids, dists, st)
        launches = launch_counts()
        stepped = st.total_rounds + st.warmup_rounds
        cap = capture_line(CACHE.stats, stepped, st.host_syncs)
        summ = stream_summary(st)
        # more sessions of the same stream (QPS spread in this process)
        repeats = [serve(kw)[2] for _ in range(STREAM_REPEATS)]
        # the stream's first TWIN_QUERIES queries run captured and again
        # eagerly on the card, outside the cache
        nt = TWIN_QUERIES
        _, _, st_twin = serve(kw, nt)
        _, _, st_eager = serve(kw, nt, capture=False)
        differ = first_difference(stream_records(st_twin, nt),
                                  stream_records(st_eager, nt))
        line = {"phase": "stream", "run": name, **kw, "queries": nq,
                "slots_per_shard": slots, "shards": SHARDS,
                "arrival_rate": STREAM["rate"],
                "round_chunk": STREAM["chunk"], "spec": STREAM["spec"],
                "injit_admit": st.injit_admit,
                "qps": nq / st.wall_s, "wall_s": st.wall_s,
                "latency_rounds": summ["latency_rounds"],
                "wall_latency_ms": summ["wall_latency_ms"],
                "occupancy": st.occupancy, "total_rounds": st.total_rounds,
                "idle_rounds": st.idle_rounds,
                "warmup_rounds": st.warmup_rounds,
                "warmup_s": st.compile_s,
                "host_dispatches": st.host_dispatches, **cap,
                "host_ms_per_round": st.wall_s * 1e3 / st.total_rounds,
                "qps_repeats": [nq / r.wall_s for r in repeats],
                "pages_unique": st.pages_unique,
                "mean_spec_w": summ["mean_spec_w"],
                "recall@k": float(recall_at_k(ids, true_ids)),
                "launches": launches,
                "launches_per_device_round": {
                    k: v / cap["device_rounds"] for k, v in launches.items()},
                "twin_queries": nt,
                "uncaptured_qps": nt / st_eager.wall_s,
                "uncaptured_host_ms_per_round":
                    st_eager.wall_s * 1e3 / st_eager.total_rounds,
                "twin_captured_qps": nt / st_twin.wall_s,
                "captured_equals_uncaptured": differ is None}
        if differ is not None:
            raise AssertionError(f"stream {name}: the captured session's "
                                 f"{differ} differs from the uncaptured one")
        check_launches(f"stream {name}", launches, cap["device_rounds"])
        if st.host_syncs != st.host_dispatches or cap["captures"] > 1 or \
                cap["replays"] != st.host_dispatches + 1:
            raise AssertionError(f"stream {name}: one read per chunk and at "
                                 f"most one capture expected: {cap}, "
                                 f"{st.host_dispatches} chunks")
        if name == "refill_static" and st.total_rounds != STATIC_ROUNDS:
            raise AssertionError(f"stream {name}: {st.total_rounds} rounds, "
                                 f"not {STATIC_ROUNDS}")
        if name == "refill_static":
            differ = np.flatnonzero((ids != shot_i).any(1))
            near = np.abs(dists - shot_d) <= NEAR_TIE * np.abs(shot_d) \
                + NEAR_TIE
            line["oneshot_search_sim_s"] = oneshot_s
            line["oneshot_search_sim_rounds"] = shot_rounds
            line["ids_differ_from_oneshot_rows"] = differ.tolist()
            if not near[differ].all():
                raise AssertionError(f"stream {name}: rows {differ} differ "
                                     f"from one-shot search_sim beyond a "
                                     f"distance near-tie")
        line["profile_window"] = profile_stream_window(
            lambda n, kw=kw: serve(kw, n)[2], host=name == "refill_static")
        drop_traces()
        emit(line)
        res[name] = line
    if abs(res["refill_dynamic"]["recall@k"]
           - res["refill_static"]["recall@k"]) > RECALL_TOL:
        raise AssertionError("dynamic speculation moved recall by more "
                             f"than {RECALL_TOL}")
    if not res["refill_static"]["occupancy"] > \
            res["frozen_static"]["occupancy"]:
        raise AssertionError("refill occupancy is not above frozen")
    return static



# ---------------------------------------------------------------------------
# Phase 7a: the tiered page store
# ---------------------------------------------------------------------------
# (a)'s integer build: phase int's vectors in 8-vector pages (32 pages per
# shard; phase int's 64-vector pages give 4, too few to tier), degree 8,
# prefetch lists of 2; its traffic: 64 queries at Poisson 0.25 per round
# into 2 slots per shard, chunk 4, L 16, spec 2 (the reference bench's
# tiered leg at 8 shards). With degree 16 every half-resident session on
# this data hits the livelock guard on the CPU.
TIERED_INT = dict(page=8, degree=8, pref=2, queries=64, rate=0.25, slots=2,
                  chunk=4, L=16, spec=2, ring=6)
# (b)'s traffic: the reference bench's tiered leg (Poisson 0.25 per round,
# 2 slots per shard, chunk 4, spec 2) scaled to the sift-1b stand-in (256
# queries, L 32, k 10) over phase main's build (32 pages per shard). At
# 0.5 and 0.25 the sessions hit the livelock guard on the CPU (so do 18
# frames), so the curve stops at 20 of 32 frames.
TIERED = dict(queries=256, rate=0.25, slots=2, chunk=4, spec=2,
              frames=(32, 28, 24, 20))
# the frame buffer of the tiered distance row in phase timing (of 32)
TIERED_TIMING_FRAMES = 24
# (c): a 2**20-vector cold tier (S 8 x NP 2048 pages of 64 x 128 f32,
# 512 MiB pinned) under 512 frames per shard (128 MiB), 64 demanded pages
# per shard per boundary; prefetch lists of 2 over a random degree-16
# graph for the predictor
CAPACITY = dict(S=8, NP=2048, P=64, d=128, device_pages=512, miss=64,
                boundaries=12, degree=16)


def timed_boundaries(ps) -> list:
    """Wrap ``ps.boundary`` so each call's host seconds are appended to the
    returned list (a boundary ends in host work: its copies and installs
    are queued, the next chunk queues behind them)."""
    times = []
    boundary = ps.boundary

    def timed(*a):
        t0 = time.perf_counter()
        out = boundary(*a)
        times.append(time.perf_counter() - t0)
        return out

    ps.boundary = timed
    return times


def tiered_records(st, n: int) -> dict:
    return {**stream_records(st, n),
            "stall_rounds": per_query(st, n, "stall_rounds")}


def payload_bytes(ps, pages: int) -> int:
    """Bytes of ``pages`` cold pages (vectors and norms) copied to the
    card."""
    return pages * ps.P * (ps.d * ps.cold_db.element_size()
                           + ps.cold_vn.element_size())


def tiered_integer(db, queries, dev):
    """(a) Phase int's integer vectors as a tiered build: sessions on the
    card against CPU ref mode (the records, stalls, the store's counters
    and final residency), full residency against the untiered session,
    both admission paths, a wrapping admission ring, the livelock guard;
    one capture per session, the consts' addresses kept across
    boundaries, one distance and one fused merge per device round.
    Returns the build (reordered vectors, packed index) for phase
    live."""
    import numpy as np
    import torch
    from repro_torch.analysis.capture_guard import CaptureGuard
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import poisson_arrivals, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import build_index

    c = TIERED_INT
    t0 = time.perf_counter()
    db_r, packed = build_index(db, shards=SHARDS, page_size=c["page"],
                               r=c["degree"], pref_width=c["pref"])
    build_s = time.perf_counter() - t0
    nq = c["queries"]
    queries = queries[:nq]
    cpu = torch.device("cpu")
    # a tiered session's build keeps its vector pages in host memory
    builds = {(w.type, tiered): pack_for_engine(packed, device=w,
                                                host_pages=tiered)
              for w in (dev, cpu) for tiered in (False, True)}
    NP = builds["cpu", False][0]["db"].shape[1]

    def session(where, frames, prefetch=True, injit=True, ring=0,
                spaced=False):
        consts, geom, entry = builds[where.type, bool(frames)]
        params = EngineParams.lossless(
            SearchParams(L=c["L"], W=1, k=K), c["slots"], c["degree"],
            spec_width=c["spec"],
            kernel_mode="cuda" if where.type == "cuda" else "ref",
            store_pages=NP if frames else 0)
        ps = PageStore(consts, geom, frames, w_select=1,
                       prefetch=prefetch) if frames else None
        seen = []
        if ps is not None:
            ptrs = {k: v.data_ptr() for k, v in ps.device_view().items()}
            boundary = ps.boundary

            def watched(*a):
                view = boundary(*a)
                seen.append({k: v.data_ptr() for k, v in view.items()}
                            == ptrs)
                return view

            ps.boundary = watched
        arrivals = (np.arange(nq) * 2 if spaced
                    else poisson_arrivals(c["rate"], nq, seed=1))
        reset_launch_counts()
        CACHE.reset_stats()
        with CaptureGuard() as guard:
            ids, dists, st = stream_search(
                consts, geom, params, entry, queries, num_slots=c["slots"],
                arrivals=arrivals, round_chunk=c["chunk"], injit_admit=injit,
                ring_capacity=ring, pagestore=ps, device=where)
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        return {"records": tiered_records(st, nq), "st": st, "cap": cap,
                "ids": ids, "dists": dists, "built": guard.names,
                "launches": launch_counts(), "addresses_kept": all(seen),
                "store": None if ps is None else (
                    ps.counters(), ps.ttab.copy(), ps.frame_page.copy())}

    untiered = session(dev, 0)
    runs = {"full": dict(frames=NP),
            "half_prefetch": dict(frames=NP // 2),
            "half_demand": dict(frames=NP // 2, prefetch=False),
            "half_prefetch_host_paced": dict(frames=NP // 2, injit=False),
            "half_demand_host_paced": dict(frames=NP // 2, prefetch=False,
                                           injit=False),
            f"half_ring{c['ring']}": dict(frames=NP // 2, ring=c["ring"],
                                          spaced=True)}
    for name, kw in runs.items():
        guarded = bool(kw.get("ring"))
        if guarded:
            # an empty cache: the session must build its one entry itself
            CACHE.entries.clear()
        card = session(dev, **kw)
        st, cap = card["st"], card["cap"]
        want = untiered if name == "full" else session(cpu, **kw)
        differ = first_difference(card["records"], want["records"])
        same_store = want["store"] is None or (
            card["store"][0] == want["store"][0]
            and all(np.array_equal(a, b) for a, b in
                    zip(card["store"][1:], want["store"][1:])))
        guard_line = {}
        if guarded:
            flat = session(cpu, 0, spaced=True)    # untiered, no ring
            guard_line = {
                "capture_guard": card["built"],
                "equals_cpu_untiered_unringed": bool(
                    np.array_equal(card["ids"], flat["ids"])
                    and np.array_equal(card["dists"].view(np.int32),
                                       flat["dists"].view(np.int32)))}
        emit({"phase": "tiered", "index": "integer", "run": name,
              "pages_per_shard": NP, "device_pages": kw["frames"],
              "prefetch": kw.get("prefetch", True),
              "injit_admit": st.injit_admit, "ring": kw.get("ring", 0),
              "queries": nq, "total_rounds": st.total_rounds,
              "stalls": st.stalls, **dict(zip(
                  ("page_hits", "page_misses", "demand_fetches",
                   "prefetch_issued", "prefetch_hits"),
                  card["store"][0].values())),
              "host_dispatches": st.host_dispatches, **cap,
              "addresses_kept": card["addresses_kept"],
              "launches_per_device_round": {
                  k: v / cap["device_rounds"]
                  for k, v in card["launches"].items() if v},
              "equals": "untiered" if name == "full" else "cpu_ref",
              "first_difference": differ, "store_equal": same_store,
              **guard_line})
        if differ is not None or not same_store:
            raise AssertionError(f"tiered integer {name}: the card's "
                                 f"session differs from its reference "
                                 f"({differ}, store equal {same_store})")
        if name == "full" and st.stalls:
            raise AssertionError("tiered integer full: stalls at full "
                                 "residency")
        if name != "full" and not st.stalls:
            raise AssertionError(f"tiered integer {name}: no stall")
        if cap["captures"] > 1 or not card["addresses_kept"] or \
                st.host_syncs != st.host_dispatches:
            raise AssertionError(f"tiered integer {name}: one capture, "
                                 f"kept addresses and one read per chunk "
                                 f"expected: {cap}, "
                                 f"{card['addresses_kept']}")
        check_launches(f"tiered integer {name}", card["launches"],
                       cap["device_rounds"])
        if guarded and (
                guard_line["capture_guard"] != ["engine_run_chunk_admit"]
                or not guard_line["equals_cpu_untiered_unringed"]):
            raise AssertionError(f"tiered integer {name}: one "
                                 f"engine_run_chunk_admit build and the "
                                 f"untiered, unringed results expected: "
                                 f"{guard_line}")
    # a cache smaller than one round's working set: the livelock guard
    try:
        session(dev, 2, prefetch=False)
    except RuntimeError as e:
        if "tiered page store livelock" not in str(e):
            raise
        guard = str(e)
    else:
        raise AssertionError("tiered integer: 2 frames per shard did not "
                             "raise the livelock guard")
    emit({"phase": "tiered", "index": "integer", "run": "livelock_guard",
          "device_pages": 2, "raised": guard,
          "host_build_s": round(build_s, 2)})
    return db_r, packed


def tiered_sift(db, packed, dev) -> dict:
    """(b) The sift-1b stand-in (phase main's build) served from a frame
    cache of TIERED["frames"] pages per shard, prefetch on and off, beside
    the untiered session: per row QPS, latency, stalls, the store's
    counters, bytes copied to the card, host ms per boundary, queries per
    clock round, launches, the card's memory in use and an estimate of
    the device idle share. Every row's ids must equal the untiered
    session's. Returns the kernels' launches in the session at
    TIERED_TIMING_FRAMES frames with prefetch, for phase timing."""
    import numpy as np
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.graph import brute_force_topk, recall_at_k
    from repro_torch.core.metrics import stream_summary
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import poisson_arrivals, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset

    c = TIERED
    nq = c["queries"]
    queries = dataset("sift-1b").queries(nq, seed=1)
    arrivals = poisson_arrivals(c["rate"], nq, seed=0)
    true_ids, _ = brute_force_topk(db, queries, K)
    NP = packed.db.shape[1]

    def serve(frames, prefetch):
        """One session on a build of its own: a tiered one keeps its
        vector pages in host memory, so the card holds only the frames."""
        consts, geom, entry = pack_for_engine(packed, device=dev,
                                              host_pages=frames > 0)
        params = EngineParams.lossless(
            SearchParams(L=L, W=W, k=K), c["slots"], DEGREE,
            spec_width=c["spec"], coalesce_qb=QB,
            store_pages=NP if frames else 0)
        ps = PageStore(consts, geom, frames, w_select=W,
                       prefetch=prefetch) if frames else None
        times = timed_boundaries(ps) if ps is not None else []
        ids, _, st = stream_search(consts, geom, params, entry, queries,
                                   num_slots=c["slots"], arrivals=arrivals,
                                   round_chunk=c["chunk"], device=dev,
                                   pagestore=ps)
        return ids, st, (None if ps is None else ps.counters()), times, ps

    def device_idle(st) -> dict:
        """An estimate of the session's device idle share: its replays
        times one replay's device time (CUDA events over back-to-back
        replays of the session's captured chunk, right after the session:
        every replay runs the same K masked rounds), against the
        session's wall time. It leaves out the boundaries' copies and
        frame installs. torch.profiler over a whole session (some 450k
        kernel records) costs tens of seconds to read back."""
        entry = next(reversed(CACHE.entries.values()))
        replay_ms = event_ms(entry.graph.replay, iters=20, warmup=2)
        busy_ms = st.host_dispatches * replay_ms
        return {"replay_ms": replay_ms, "replay_busy_ms": busy_ms,
                "device_idle_share_estimate":
                    1.0 - busy_ms / (st.wall_s * 1e3)}

    base_ids = None
    out = {}
    for frames, prefetch in [(0, False)] + [
            (f, p) for f in c["frames"] for p in (True, False)]:
        # the card's memory in use: a session's peak over what the process
        # held before it, with no captured chunk of an earlier row alive
        CACHE.entries.clear()
        gc.collect()
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, st, counters, times, ps = serve(frames, prefetch)
        torch.cuda.synchronize()
        session_mib = (torch.cuda.max_memory_allocated(dev)
                       - base_mem) / 2**20
        launches = launch_counts()
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        summ = stream_summary(st)
        clock = st.total_rounds + st.idle_rounds
        if base_ids is None:
            base_ids = ids
        differ = np.flatnonzero((ids != base_ids).any(1))
        line = {"phase": "tiered", "index": "sift-1b",
                "run": "untiered" if not frames else
                f"frames{frames}_{'prefetch' if prefetch else 'demand'}",
                "pages_per_shard": NP, "device_pages": frames or NP,
                "resident_fraction": st.resident_fraction,
                "prefetch": prefetch, "queries": nq,
                "arrival_rate": c["rate"], "slots_per_shard": c["slots"],
                "round_chunk": c["chunk"], "spec": c["spec"],
                "qps": nq / st.wall_s, "wall_s": st.wall_s,
                "latency_rounds": summ["latency_rounds"],
                "wall_latency_ms": summ["wall_latency_ms"],
                "stall_rounds_per_query": st.stalls / nq,
                "total_rounds": st.total_rounds,
                "idle_rounds": st.idle_rounds, "clock_rounds": clock,
                "queries_per_clock_round": nq / clock,
                "recall@k": float(recall_at_k(ids, true_ids)),
                "host_dispatches": st.host_dispatches, **cap,
                "launches": {k: v for k, v in launches.items() if v},
                "launches_per_device_round": {
                    k: v / cap["device_rounds"]
                    for k, v in launches.items() if v},
                "ids_differ_from_untiered_rows": differ.tolist(),
                "device_peak_mib_over_base": session_mib,
                "vector_pages_on_device_mib": (
                    packed.db.nbytes + packed.vnorm.nbytes) / 2**20
                if ps is None else (ps.frames.nbytes
                                    + ps.vnf.nbytes) / 2**20}
        if ps is not None:
            line.update(counters, prefetch_hit_rate=(
                counters["prefetch_hits"] / counters["prefetch_issued"]
                if counters["prefetch_issued"] else 0.0),
                h2d_bytes=payload_bytes(ps, counters["demand_fetches"]
                                        + counters["prefetch_issued"]),
                boundaries=len(times),
                host_ms_per_boundary=1e3 * sum(times) / max(len(times), 1))
        line.update(device_idle(st))
        del ps
        # one more session of the same row (QPS spread in this process)
        line["qps_repeat"] = nq / serve(frames, prefetch)[1].wall_s
        emit(line)
        out[line["run"]] = line
        if differ.size:
            raise AssertionError(f"tiered sift {line['run']}: rows "
                                 f"{differ.tolist()} differ from the "
                                 f"untiered session")
        check_launches(f"tiered sift {line['run']}", launches,
                       cap["device_rounds"])
        if frames == NP and st.stalls:
            raise AssertionError("tiered sift: stalls at full residency")
        if st.host_syncs != st.host_dispatches or cap["captures"] > 1:
            raise AssertionError(f"tiered sift {line['run']}: one read per "
                                 f"chunk and one capture expected: {cap}")
    full = out[f"frames{NP}_prefetch"]
    if full["total_rounds"] != out["untiered"]["total_rounds"] or \
            full["latency_rounds"] != out["untiered"]["latency_rounds"]:
        raise AssertionError("tiered sift: full residency changed the "
                             "schedule")
    return out[f"frames{TIERED_TIMING_FRAMES}_prefetch"]["launches"]


def capacity_check(dev) -> None:
    """(c) The store itself at size: a 2**20-vector cold tier pinned on
    the host (it never lies on the card whole) under a quarter of it in
    frames. boundary() is driven directly with synthetic bitmaps
    (CAPACITY["miss"] demanded and as many touched pages per shard) and
    random candidate lists; the frames must equal the cold tier row for
    row. Printed: the card's memory the store holds, the demand path's
    host ms per boundary and host-to-device GB/s against one large pinned
    copy_, and the overlap of a staged prefetch copy with a kernel loop
    queued after the boundary, as the next chunk's replay is (it fails
    unless the two together take clearly less than one after the
    other)."""
    import numpy as np
    import torch
    from repro_torch.core.engine import EngineGeom
    from repro_torch.core.pagestore import PageStore

    c = CAPACITY
    S, NP, P, d = c["S"], c["NP"], c["P"], c["d"]
    n = S * NP * P
    gc.collect()
    torch.cuda.synchronize()
    base_mem = torch.cuda.memory_allocated(dev)
    g = torch.Generator(device=dev).manual_seed(9)
    t0 = time.perf_counter()
    db = torch.randn((S, NP, P, d), generator=g, device=dev)
    vnorm = (db * db).sum(-1).cpu()
    db = db.cpu()                  # the pages live on the host only
    adj = torch.randint(0, n, (S, NP * P, c["degree"]), generator=g,
                        device=dev, dtype=torch.int32)
    consts = {"db": db, "vnorm": vnorm, "adj": adj,
              "pref": adj[..., :2].contiguous(),
              "blk_perm": torch.arange(NP // 4, dtype=torch.int32,
                                       device=dev).expand(S, -1)}
    geom = EngineGeom(num_shards=S, page_size=P, pages_per_block=4,
                      pages_per_shard=NP, dim=d, max_degree=c["degree"],
                      spec_stored=2, n=n)
    ps = PageStore(consts, geom, c["device_pages"], w_select=1)
    del consts, db, vnorm, adj
    gc.collect()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_mem = torch.cuda.memory_allocated(dev) - base_mem
    rng = np.random.default_rng(0)

    def fresh():
        """Random candidate lists: each quiet boundary stages new pages."""
        return (rng.integers(0, n, (S, 2, 32)).astype(np.int32),
                np.zeros((S, 2, 32), bool), np.zeros((S, 2), bool))

    cands = fresh()
    quiet = np.zeros((S, NP), bool)

    def bitmaps():
        touch, miss = quiet.copy(), quiet.copy()
        for s in range(S):
            touch[s, rng.choice(np.flatnonzero(ps.ttab[s] >= 0), c["miss"],
                                replace=False)] = True
            miss[s, rng.choice(np.flatnonzero(ps.ttab[s] < 0), c["miss"],
                               replace=False)] = True
        return touch, miss

    demand_ms = []
    for _ in range(c["boundaries"]):
        touch, miss = bitmaps()
        t0 = time.perf_counter()
        ps.boundary(touch, miss, *cands)
        torch.cuda.synchronize()
        demand_ms.append((time.perf_counter() - t0) * 1e3)
    demanded = payload_bytes(ps, S * c["miss"])
    # one large pinned copy in the same run: a quarter of the cold tier
    src = ps.cold_db.view(-1, P, d)[:S * c["device_pages"]]
    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    dst.copy_(src, non_blocking=True)
    torch.cuda.synchronize()
    start.record()
    dst.copy_(src, non_blocking=True)
    end.record()
    torch.cuda.synchronize()
    big_ms = start.elapsed_time(end)
    del dst

    # overlap, in the order of a session: a quiet boundary (it commits the
    # last stage and stages S * budget pages, copied on the side stream),
    # then a matmul loop on the current stream, as the next chunk's replay
    # is queued. A gate of large matmuls holds the card while the host
    # runs the boundary, so both start together when it ends, and each is
    # timed from the gate's end on the card's clock (CUDA events).
    def mm(x, loops):
        for _ in range(loops):
            torch.mm(x, x)

    def mm_ms(x):
        mm(x, 2)
        start.record()
        mm(x, 10)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 10

    t0 = time.perf_counter()
    ps.boundary(quiet, quiet, *fresh())
    stage_host_ms = (time.perf_counter() - t0) * 1e3
    # the store's memory on the card once its landing buffers exist (read
    # before the matmuls' operands and BLAS workspace are allocated)
    torch.cuda.synchronize()
    store_mem = torch.cuda.memory_allocated(dev) - base_mem
    small = torch.randn((1024, 1024), device=dev)
    large = torch.randn((4096, 4096), device=dev)
    gate = math.ceil(3 * stage_host_ms / mm_ms(large)) + 1

    def staged_run(loops):
        """(ms from the gate's end to the staged copy's end, to the
        loop's end, whether the gate outlasted the boundary's host work,
        pages staged)."""
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        torch.cuda.synchronize()
        issued = ps.prefetch_issued
        args = (quiet, quiet, *fresh())
        mm(large, gate)
        marks[0].record()
        ps.boundary(*args)
        held = not marks[0].query()
        if ps._staged is None:
            raise AssertionError("capacity check: nothing was staged")
        marks[1].record(ps._side)    # behind the staged copy
        mm(small, loops)
        marks[2].record()
        torch.cuda.synchronize()
        return (marks[0].elapsed_time(marks[1]),
                marks[0].elapsed_time(marks[2]), held,
                ps.prefetch_issued - issued)

    copy_ms, _, held_a, staged = staged_run(0)
    loops = max(1, round(copy_ms / mm_ms(small)))
    start.record()
    mm(small, loops)
    end.record()
    torch.cuda.synchronize()
    loop_ms = start.elapsed_time(end)
    copy_b, loop_b, held_b, staged2 = staged_run(loops)
    both_ms = max(copy_b, loop_b)
    serial_ms = copy_ms + loop_ms
    # one after the other they take the sum; overlapped about the larger
    overlapped = serial_ms - both_ms > 0.5 * min(copy_ms, loop_ms)
    del small, large
    ps.boundary(quiet, quiet, *fresh())       # commit the last stage
    torch.cuda.synchronize()
    # every resident frame equals its cold page, row for row
    pages = [(s, p) for s in range(S) for p in np.flatnonzero(
        ps.ttab[s] >= 0)]
    src_i = torch.as_tensor([s * NP + p for s, p in pages])
    dst_i = torch.as_tensor([s * ps.P_dev + int(ps.ttab[s, p])
                             for s, p in pages], device=dev)
    equal = True
    for lo in range(0, len(pages), 512):     # 16 MiB at a time
        want = ps.cold_db.view(-1, P, d)[src_i[lo:lo + 512]].to(dev)
        got = ps.frames.view(-1, P, d)[dst_i[lo:lo + 512]]
        equal &= bool(torch.equal(got, want))
    equal &= bool(torch.equal(
        ps.vnf.view(-1, P)[dst_i],
        ps.cold_vn.view(-1, P)[src_i].to(dev)))
    emit({"phase": "tiered", "check": "capacity", "vectors": n,
          "cold_tier_mib": ps.cold_db.nbytes / 2**20,
          "frames_mib": ps.frames.nbytes / 2**20, "pinned":
          ps.cold_db.is_pinned(), "setup_s": setup_s,
          "device_mib_after_setup": setup_mem / 2**20,
          "device_mib_after_first_stage": store_mem / 2**20,
          "boundaries": c["boundaries"],
          "demanded_pages_per_boundary": S * c["miss"],
          "demanded_bytes_per_boundary": demanded,
          "demand_host_ms_per_boundary": demand_ms,
          "demand_gb_s": [demanded / t / 1e6 for t in demand_ms],
          "pinned_copy_mib": src.nbytes / 2**20, "pinned_copy_ms": big_ms,
          "pinned_copy_gb_s": src.nbytes / big_ms / 1e6,
          "counters": ps.counters(), "staged_pages": [staged, staged2],
          "staged_bytes": payload_bytes(ps, staged),
          "stage_boundary_host_ms": stage_host_ms, "gate_mm": gate,
          "gate_held": [held_a, held_b],
          "staged_copy_ms": copy_ms, "loop_mm": loops,
          "loop_ms": loop_ms, "staged_copy_ms_beside_loop": copy_b,
          "loop_ms_beside_copy": loop_b, "both_ms": both_ms,
          "serial_ms": serial_ms, "overlapped": overlapped,
          "frames_equal_cold_tier": equal, "resident_pages": len(pages)})
    if not equal:
        raise AssertionError("capacity check: a frame differs from its "
                             "cold-tier page")
    if not ps.cold_db.is_pinned():
        raise AssertionError("capacity check: the cold tier is not pinned")
    if staged2 < staged // 2:
        raise AssertionError(f"capacity check: the two staged payloads "
                             f"differ too much to compare ({staged}, "
                             f"{staged2} pages)")
    if not (held_a and held_b):
        raise AssertionError("capacity check: the gate ended before the "
                             "boundary's host work; the overlap timing "
                             "does not hold")
    if not overlapped:
        raise AssertionError(f"capacity check: the staged copy did not "
                             f"overlap the loop ({both_ms} ms together, "
                             f"{copy_ms} + {loop_ms} ms alone)")


# ---------------------------------------------------------------------------
# Phase 7b: the live index
# ---------------------------------------------------------------------------
# (a)'s integer sessions: phase tiered's integer build (phase int's vectors
# in 8-vector pages, degree 8, prefetch lists of 2) and traffic (64
# queries at Poisson 0.25 per round, 2 slots per shard, chunk 4, L 16,
# spec 2), with Poisson inserts at 0.15 and deletes at 0.05 per round over
# 320 rounds, integer payloads next to the queries, a delta of 16 rows:
# two or three epoch swaps before the last query retires
LIVE_INT = dict(insert=0.15, delete=0.05, horizon=320, delta_cap=16, seed=5)
# (b)'s churn: the reference bench's live rates (benchmarks/
# bench_serving.py:399) on the stream phase's traffic, the schedule over
# the reference CLI's horizon (build_live_session), a delta of 128 rows,
# refresh_every 0: about 150 inserts before the last query retires, one
# swap
LIVE = dict(insert=0.35, delete=0.1, delta_cap=128, seed=5)
# the churn session's live set: the stand-in's first 4096 vectors (cut
# from phase main's 16384: a reindex of that whole set took 129-206
# host s on the card's host, the longest step of the script), built
# as phase main's in the host pool; the stream's 392 rounds insert 157
# vectors into a delta of 128: one swap
CHURN = dict(n=4096, delta_cap=128)
# (c)'s tiered live sessions: phase tiered's traffic at 28 frames (of 33
# pages per shard at the live capacity), the same rates and a delta of
# 512 rows: no swap, and the live consts copied at nearly every boundary
LIVE_TIERED = dict(frames=28, delta_cap=512)


@contextlib.contextmanager
def memo_reindex():
    """Within the block a reindex (``LiveIndex.refresh``) of a live set
    already reindexed with the same seed, width and layout returns a copy
    of that epoch instead of building it again: the twin sessions of one
    schedule (captured and uncaptured on the card, ref mode on the CPU)
    reach the same epochs, and each build costs seconds of host time. The
    first session of a schedule builds every epoch itself. Yields the
    counts of built and reused epochs."""
    import copy
    import hashlib
    import numpy as np
    from repro_torch.core import live as live_mod

    real = live_mod.reindex_epoch
    cache, counts = {}, {"built": 0, "reused": 0}

    def memo(ep, *, seed=0, pref_width=0):
        m = (ep.ext_ids >= 0) & ~ep.tombs
        h = hashlib.sha1()
        for a in (ep.vectors[m], ep.ext_ids[m], ep.delta_vec[ep.delta_live],
                  ep.delta_ext[ep.delta_live]):
            h.update(np.ascontiguousarray(a).tobytes())
        key = (h.hexdigest(), ep.epoch, ep.capacity, ep.delta_cap,
               ep.packed.max_degree, ep.packed.geometry, seed, pref_width)
        if key in cache:
            counts["reused"] += 1
        else:
            cache[key] = real(ep, seed=seed, pref_width=pref_width)
            counts["built"] += 1
        return copy.deepcopy(cache[key])

    live_mod.reindex_epoch = memo
    try:
        yield counts
    finally:
        live_mod.reindex_epoch = real


@contextlib.contextmanager
def timed_swaps():
    """Within the block every scheduler's epoch swap (the consts' and the
    entry's writes, the translation of in-flight lists, the restarts)
    appends its host seconds to the yielded list; the reindex before it
    is ``LiveIndex.reindex_s``."""
    from repro_torch.core.scheduler import StreamScheduler
    real = StreamScheduler._swap_epoch
    times = []

    def timed(self, *a):
        t0 = time.perf_counter()
        out = real(self, *a)
        times.append(time.perf_counter() - t0)
        return out

    StreamScheduler._swap_epoch = timed
    try:
        yield times
    finally:
        StreamScheduler._swap_epoch = real


def live_records(st, n: int) -> dict:
    return {**tiered_records(st, n), **{k: getattr(st, k) for k in (
        "epoch_swaps", "delta_hits", "tombstoned", "swap_stall_rounds",
        "total_rounds", "host_dispatches")}}


def live_epoch(live) -> dict:
    ep = live.ep
    return {"epoch": ep.epoch, "ext_ids": ep.ext_ids, "tombs": ep.tombs,
            "delta_vec": ep.delta_vec, "delta_live": ep.delta_live,
            "delta_ext": ep.delta_ext}


def live_integer(build, queries, dev) -> None:
    """(a) Live sessions on phase tiered's integer build: zero churn
    against the frozen stream; a churn session (>= 2 swaps) flat, on a
    half-resident tiered store and routed at topr = S, each captured on
    the card against the same session uncaptured and in ref mode on the
    CPU (every per-query record, the live counters, the final epoch's
    external ids, tombstones and delta), one capture per session, its
    launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.live import (MutationSchedule,
                                       live_index_from_graph,
                                       mutation_schedule)
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.router import build_live_router
    from repro_torch.core.scheduler import (poisson_arrivals,
                                            routed_stream_search,
                                            stream_search)
    from repro_torch.kernels import launch_counts, reset_launch_counts

    db, packed = build
    c, lc = TIERED_INT, LIVE_INT
    nq = c["queries"]
    queries = queries[:nq]
    adj = flat_adjacency(packed)
    arrivals = poisson_arrivals(c["rate"], nq, seed=1)
    rng = np.random.default_rng(lc["seed"])
    s = mutation_schedule(lc["insert"], lc["delete"], lc["horizon"],
                          db.shape[1], seed=lc["seed"])
    vec = np.zeros_like(s.vec)
    near = queries[rng.integers(0, nq, s.num_inserts)]
    vec[s.is_ins] = near + rng.integers(-1, 2, near.shape)
    churn = MutationSchedule(t=s.t, is_ins=s.is_ins, vec=vec)
    cpu = torch.device("cpu")

    def session(kind, where, capture=True, schedule=churn, live_on=True):
        mode = "cuda" if where.type == "cuda" else "ref"
        live = live_index_from_graph(
            db, adj, packed.entry, shards=SHARDS, page_size=c["page"],
            r=c["degree"], delta_cap=lc["delta_cap"],
            capacity=len(db) + (schedule.num_inserts if schedule else 0),
            pref_width=c["pref"], seed=lc["seed"], schedule=schedule)
        consts, geom, entry = pack_for_engine(
            live.ep.packed, device=where, host_pages=kind == "tiered")
        params = EngineParams.lossless(
            SearchParams(L=c["L"], W=1, k=K), c["slots"], c["degree"],
            spec_width=c["spec"], kernel_mode=mode,
            delta_cap=lc["delta_cap"] if live_on else 0)
        kw = dict(num_slots=c["slots"], arrivals=arrivals,
                  round_chunk=c["chunk"], injit_admit=True, device=where,
                  capture=capture, live=live if live_on else None)
        reset_launch_counts()
        CACHE.reset_stats()
        if kind == "routed":
            live.router = build_live_router(live.ep, seed=lc["seed"],
                                            kernel_mode=mode, device=where)
            _, _, st = routed_stream_search(
                consts, geom, params, entry, queries, router=live.router,
                topr=SHARDS, **kw)
        else:
            ps = None
            if kind == "tiered":
                NP = consts["db"].shape[1]
                ps = PageStore(consts, geom, NP // 2, w_select=1)
                params = dataclasses.replace(params, store_pages=NP)
            _, _, st = stream_search(consts, geom, params, entry, queries,
                                     pagestore=ps, **kw)
        return {"records": live_records(st, nq), "st": st,
                "cap": capture_line(CACHE.stats,
                                    st.total_rounds + st.warmup_rounds,
                                    st.host_syncs),
                "launches": launch_counts(), "epoch": live_epoch(live),
                "reindex_s": live.reindex_s}

    with memo_reindex() as builds:
        # zero churn: the live session with no mutation is the frozen one
        zero = session("flat", dev, schedule=None)
        frozen = session("flat", dev, schedule=None, live_on=False)
        differ = first_difference(zero["records"], frozen["records"])
        emit({"phase": "live", "index": "integer", "run": "zero_churn",
              "queries": nq, "total_rounds": zero["st"].total_rounds,
              "host_dispatches": zero["st"].host_dispatches, **zero["cap"],
              "equals": "frozen stream", "first_difference": differ})
        if differ is not None or zero["cap"]["captures"] != 1:
            raise AssertionError(f"live integer zero churn: {differ} "
                                 f"differs from the frozen stream, or "
                                 f"{zero['cap']['captures']} captures")
        for kind in ("flat", "tiered", "routed"):
            card = session(kind, dev)
            st, cap = card["st"], card["cap"]
            checks = {}
            for other, kw in (("uncaptured", dict(where=dev, capture=False)),
                              ("cpu_ref", dict(where=cpu))):
                want = session(kind, **kw)
                checks[other] = first_difference(card["records"],
                                                 want["records"]) or \
                    first_difference(card["epoch"], want["epoch"])
            line = {"phase": "live", "index": "integer", "run": kind,
                    "queries": nq, "delta_cap": lc["delta_cap"],
                    "capacity": len(db) + churn.num_inserts,
                    "scheduled_inserts": churn.num_inserts,
                    **{k: getattr(st, k) for k in (
                        "epoch_swaps", "delta_hits", "tombstoned",
                        "swap_stall_rounds", "total_rounds", "stalls",
                        "host_dispatches")},
                    **cap, "reindex_s": card["reindex_s"],
                    "launches_per_device_round": {
                        k: v / cap["device_rounds"]
                        for k, v in card["launches"].items() if v},
                    "first_difference": checks}
            emit(line)
            if any(v is not None for v in checks.values()):
                raise AssertionError(f"live integer {kind}: the captured "
                                     f"session differs: {checks}")
            if st.epoch_swaps < 2 or cap["captures"] != 1 or \
                    st.host_syncs != st.host_dispatches:
                raise AssertionError(f"live integer {kind}: >= 2 swaps, "
                                     f"one capture and one read per chunk "
                                     f"expected: {st.epoch_swaps}, {cap}")
            if kind == "routed":
                routed_launches("live integer routed", card["launches"],
                                cap["device_rounds"], 1)
            else:
                check_launches(f"live integer {kind}", card["launches"],
                               cap["device_rounds"])
    emit({"phase": "live", "index": "integer", "reindex_epochs": builds})


def live_sift(db, packed, static, churn_build, dev) -> None:
    """(b) The sift-1b stand-in (phase main's build) served live with the
    stream phase's traffic: zero churn against phase stream's refill
    static session (ids, dists, rounds, dispatches), then churn at the
    reference bench's rates on ``churn_build`` (the async result of
    :func:`build_churn_sift`: each swap a reindex of the whole live set
    on the host); (c) live sessions on a tiered store at phase tiered's
    traffic, prefetch on and off."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.graph import brute_force_topk, recall_at_k
    from repro_torch.core.live import (LiveIndex, live_index_from_graph,
                                       mutation_schedule)
    from repro_torch.core.luncsr import EpochIndex
    from repro_torch.core.metrics import stream_summary
    from repro_torch.core.pagestore import PageStore
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import poisson_arrivals, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset

    nq, slots = STREAM["queries"], STREAM["slots"]
    queries = dataset("sift-1b").queries(nq, seed=1)
    arrivals = poisson_arrivals(STREAM["rate"], nq, seed=0)
    adj = flat_adjacency(packed)
    pref = packed.pref.shape[-1]
    n0 = len(db)

    def churn_live(rate_q, n, delta_cap, base=(db, packed, adj)):
        """Epoch 0 = ``base``'s graph (phase main's by default) packed at
        its size + the scheduled inserts, the schedule over
        build_live_session's horizon."""
        vecs, pk, ad = base
        arr = poisson_arrivals(rate_q, n, seed=0)
        sched = mutation_schedule(LIVE["insert"], LIVE["delete"],
                                  max(int(arr.max()) + 1, 2 * n), DIM,
                                  seed=LIVE["seed"], ref=vecs)
        return live_index_from_graph(
            vecs, ad, pk.entry, shards=SHARDS, page_size=PAGE, r=DEGREE,
            delta_cap=delta_cap, capacity=len(vecs) + sched.num_inserts,
            pref_width=pref, schedule=sched)

    def serve(live, **kw):
        consts, geom, entry = pack_for_engine(live.ep.packed, device=dev)
        params = EngineParams.lossless(
            SearchParams(L=L, W=W, k=K), slots, DEGREE,
            spec_width=STREAM["spec"], coalesce_qb=QB,
            delta_cap=live.delta_cap)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = stream_search(
            consts, geom, params, entry, queries, num_slots=slots,
            arrivals=arrivals, round_chunk=STREAM["chunk"], injit_admit=True,
            live=live, device=dev, **kw)
        launches = launch_counts()
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        return ids, dists, st, launches, cap

    def line(run, st, cap, launches, live, ids, **extra):
        summ = stream_summary(st)
        vecs, exts = live.final_dataset()
        true_ids = exts[brute_force_topk(vecs, queries, K)[0]]
        return {"phase": "live", "index": "sift-1b", "run": run,
                "queries": nq, "slots_per_shard": slots,
                "arrival_rate": STREAM["rate"], "delta_cap": live.delta_cap,
                "capacity": live.capacity, "qps": nq / st.wall_s,
                "wall_s": st.wall_s,
                "latency_rounds": summ["latency_rounds"],
                "wall_latency_ms": summ["wall_latency_ms"],
                **{k: getattr(st, k) for k in (
                    "epoch_swaps", "delta_hits", "tombstoned",
                    "swap_stall_rounds", "total_rounds", "host_dispatches",
                    "warmup_rounds")},
                "inserts": live.inserts, "deletes": live.deletes,
                "recall@k_final_dataset": float(recall_at_k(ids, true_ids)),
                **cap, "launches": launches, **extra}

    s_ids, s_dists, s_st = static
    s_summ = stream_summary(s_st)
    zero = LiveIndex(EpochIndex.empty(packed, db, np.arange(n0),
                                      LIVE["delta_cap"]), pref_width=pref)
    ids, dists, st, launches, cap = serve(zero)
    same = {"ids": np.array_equal(ids, s_ids),
            "dists": np.array_equal(dists.view(np.int32),
                                    s_dists.view(np.int32)),
            "total_rounds": st.total_rounds == s_st.total_rounds,
            "host_dispatches": st.host_dispatches == s_st.host_dispatches}
    emit(line("zero_churn", st, cap, launches, zero, ids,
              stream_refill_static_qps=nq / s_st.wall_s,
              equals_stream_refill_static=same))
    if not all(same.values()) or cap["captures"] != 1:
        raise AssertionError(f"live sift zero churn: differs from phase "
                             f"stream's refill static session ({same}) "
                             f"or {cap['captures']} captures")
    check_launches("live sift zero churn", launches, cap["device_rounds"])

    c_db, c_packed, c_build_s = churn_build.get()
    live = churn_live(STREAM["rate"], nq, CHURN["delta_cap"],
                      base=(c_db, c_packed, flat_adjacency(c_packed)))
    with timed_swaps() as swap_s:
        ids, _, st, launches, cap = serve(live)
    emit(line("churn", st, cap, launches, live, ids,
              live_set_vectors=len(c_db), churn_build_host_s=c_build_s,
              scheduled_inserts=live.schedule.num_inserts,
              reindex_s_per_swap=live.reindex_s / max(live.swaps, 1),
              swap_s=swap_s,
              stream_refill_static={
                  "qps": nq / s_st.wall_s,
                  "latency_rounds": s_summ["latency_rounds"],
                  "wall_latency_ms": s_summ["wall_latency_ms"]}))
    if st.epoch_swaps < 1 or cap["captures"] != 1 or \
            st.host_syncs != st.host_dispatches:
        raise AssertionError(f"live sift churn: >= 1 swap and one capture "
                             f"expected: {st.epoch_swaps}, {cap}")
    check_launches("live sift churn", launches, cap["device_rounds"])

    # (c) live + tiered, prefetch on and off in turns (A B B A): the
    # live consts' copy at a boundary is queued behind the stage's
    t = TIERED
    tq = dataset("sift-1b").queries(t["queries"], seed=1)
    tarr = poisson_arrivals(t["rate"], t["queries"], seed=0)
    rows = {}
    for turn, run in enumerate(("prefetch", "demand", "demand", "prefetch")):
        prefetch = run == "prefetch"
        live = churn_live(t["rate"], t["queries"], LIVE_TIERED["delta_cap"])
        consts, geom, entry = pack_for_engine(live.ep.packed, device=dev,
                                              host_pages=True)
        ps = PageStore(consts, geom, LIVE_TIERED["frames"], w_select=W,
                       prefetch=prefetch)
        times = timed_boundaries(ps)
        params = EngineParams.lossless(
            SearchParams(L=L, W=W, k=K), t["slots"], DEGREE,
            spec_width=t["spec"], coalesce_qb=QB,
            store_pages=ps.num_pages, delta_cap=live.delta_cap)
        reset_launch_counts()
        CACHE.reset_stats()
        ids, _, st = stream_search(
            consts, geom, params, entry, tq, num_slots=t["slots"],
            arrivals=tarr, round_chunk=t["chunk"], pagestore=ps, live=live,
            device=dev)
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        summ = stream_summary(st)
        if run in rows and not np.array_equal(rows[run], ids):
            raise AssertionError(f"live sift tiered {run}: the second "
                                 f"turn's ids differ from the first's")
        rows[run] = ids
        emit({"phase": "live", "index": "sift-1b", "run": "tiered_" + run,
              "turn": turn, "queries": t["queries"],
              "arrival_rate": t["rate"], "slots_per_shard": t["slots"],
              "device_pages": ps.P_dev,
              "pages_per_shard": ps.NP, "delta_cap": live.delta_cap,
              "qps": t["queries"] / st.wall_s,
              "latency_rounds": summ["latency_rounds"],
              "wall_latency_ms": summ["wall_latency_ms"],
              "stalls_per_query": st.stalls / t["queries"],
              "host_ms_per_boundary": 1e3 * float(np.mean(times)),
              **{k: getattr(st, k) for k in (
                  "epoch_swaps", "delta_hits", "tombstoned", "total_rounds",
                  "host_dispatches")},
              "inserts": live.inserts, **ps.counters(), **cap})
        if st.epoch_swaps or cap["captures"] != 1:
            raise AssertionError(f"live sift tiered {run}: no swap and one "
                                 f"capture expected: {st.epoch_swaps}, "
                                 f"{cap}")
        check_launches(f"live sift tiered {run}", launch_counts(),
                       cap["device_rounds"])


# ---------------------------------------------------------------------------
# Phase 7c: two-tier routed serving
# ---------------------------------------------------------------------------
# routed builds: 8 centroids per shard; (b) keeps the stream phase's
# traffic with prefetch lists of 4 (spec 4) and serves topr 2 (the
# default leg_L) and 8 (every shard: the fan-out semantics)
ROUTED = dict(centroids=8, spec=4, toprs=(2, SHARDS), window=512)
# (a)'s integer sessions: 8 slots per shard, chunk 8, a kill of shard 2
# at round 6 under a deadline of 60 rounds, a ring of 4
ROUTED_INT = dict(slots=8, chunk=8, deadline=60, ring=4)


def routed_on(ri, dev):
    """A routed index built on the host, with its router (auto mode) and
    its shard entries on ``dev``."""
    import dataclasses
    from repro_torch.core.backend import KernelBackend
    router = dataclasses.replace(
        ri.router, centroids=ri.router.centroids.to(dev),
        cnorm=ri.router.cnorm.to(dev), backend=KernelBackend())
    return dataclasses.replace(ri, router=router, shard_entries=tuple(
        x.to(dev) for x in ri.shard_entries))


def routed_launches(what: str, launches: dict, device_rounds: int,
                    R: int) -> None:
    """One routed session's launches: the router's distance call and one
    distance launch per device round of the legs, the route's sort once,
    the fusion's R - 1 merges, the fused Gather merge once per device
    round."""
    want = {"paged_distance": 1 + device_rounds, "bitonic_sort": 1,
            "bitonic_merge": R - 1, "bitonic_merge_unsorted": device_rounds}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


def routed_integer(db, queries, dev):
    """(a) Phase int's integer data as a routed build: routed sessions
    captured on the card against CPU ref mode, and the flat stream with
    a ring of 4 under block and shed. Returns the routed build (host
    tensors), for phase mesh."""
    import numpy as np
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.router import build_routed_index
    from repro_torch.core.scheduler import routed_stream_search, stream_search
    from repro_torch.ft.inject import fault_plan
    from repro_torch.kernels import launch_counts, reset_launch_counts

    nq, slots, chunk = len(queries), ROUTED_INT["slots"], ROUTED_INT["chunk"]
    t0 = time.perf_counter()
    ri = build_routed_index(db, shards=SHARDS, page_size=PAGE, r=DEGREE,
                            centroids_per_shard=ROUTED["centroids"],
                            pref_width=8, kernel_mode="ref", device="cpu")
    build_s = time.perf_counter() - t0
    where = {"cuda": dev, "ref": "cpu"}
    built = {"cuda": routed_on(ri, dev), "ref": ri}
    engines = {m: pack_for_engine(ri.packed, device=w)
               for m, w in where.items()}
    arrivals = np.random.default_rng(3).integers(0, 64, nq)
    sp = SearchParams(L=32, W=1, k=10)
    kill = dict(faults=fault_plan(SHARDS).kill(2, 6),
                deadline_rounds=ROUTED_INT["deadline"])
    sessions = {"topr2_in_device": (2, True, None, {}),
                "topr2_host_paced": (2, False, None, {}),
                f"topr{SHARDS}_in_device": (SHARDS, True, None, {}),
                f"topr{SHARDS}_host_paced": (SHARDS, False, None, {}),
                "topr2_down_shards_1": (2, True, [1], {}),
                "topr2_kill_deadline": (2, True, None, kill)}
    for name, (topr, injit, down, extra) in sessions.items():
        out = {}
        for mode, w in where.items():
            consts, geom, entry = engines[mode]
            params = EngineParams.lossless(sp, slots, DEGREE,
                                           kernel_mode=mode, **extra)
            reset_launch_counts()
            CACHE.reset_stats()
            _, _, st = routed_stream_search(
                consts, geom, params, entry, queries,
                router=built[mode].router, topr=topr, num_slots=slots,
                arrivals=arrivals, round_chunk=chunk, injit_admit=injit,
                shard_entries=built[mode].shard_entries, down_shards=down,
                device=w)
            out[mode] = (stream_records(st, nq) | {
                f: per_query(st, nq, f) for f in ("legs_fused",
                                                  "stall_rounds")},
                {"legs": st.legs, "legs_fused_hist": st.legs_fused_hist,
                 "items_by_shard": st.items_by_shard,
                 "truncated": st.truncated, "total_rounds": st.total_rounds})
            if mode == "cuda":
                launches = launch_counts()
                cap = capture_line(CACHE.stats,
                                   st.total_rounds + st.warmup_rounds,
                                   st.host_syncs)
        differ = first_difference(out["cuda"][0], out["ref"][0])
        same = differ is None and out["cuda"][1] == out["ref"][1]
        R = 1 if topr >= SHARDS else topr
        emit({"phase": "routed", "index": "integer", "run": name,
              "topr": topr, "injit_admit": injit, "down_shards": down or [],
              "queries": nq, "slots_per_shard": slots, **out["ref"][1],
              **cap, "launches": {k: v for k, v in launches.items() if v},
              "cuda_equals_cpu_ref": same, "first_difference": differ})
        if not same:
            raise AssertionError(f"routed {name}: the card's session "
                                 f"differs from CPU ref mode ({differ})")
        routed_launches(f"routed {name}", launches, cap["device_rounds"], R)
        # a session whose staged queue lands at an earlier session's
        # addresses replays that session's capture
        if cap["captures"] > 1:
            raise AssertionError(f"routed {name}: {cap['captures']} "
                                 f"captures, at most one expected")
        if (extra and not out["ref"][1]["truncated"]
                or down and not out["ref"][1]["legs_fused_hist"][1]):
            raise AssertionError(f"routed {name} did not bite: "
                                 f"{out['ref'][1]}")
    for overload in ("block", "shed"):
        out = {}
        for mode, w in where.items():
            consts, geom, entry = engines[mode]
            params = EngineParams.lossless(sp, slots, DEGREE,
                                           kernel_mode=mode)
            CACHE.reset_stats()
            _, _, st = stream_search(
                consts, geom, params, entry, queries, num_slots=slots,
                arrivals=arrivals, round_chunk=chunk, injit_admit=True,
                ring_capacity=ROUTED_INT["ring"], overload=overload,
                device=w)
            out[mode] = (stream_records(st, nq), {
                "shed": st.shed, "served": len(st.results),
                "total_rounds": st.total_rounds})
            if mode == "cuda":
                captures = CACHE.stats.captures
        differ = first_difference(out["cuda"][0], out["ref"][0])
        same = differ is None and out["cuda"][1] == out["ref"][1]
        emit({"phase": "routed", "index": "integer", "run": f"ring_{overload}",
              "ring": ROUTED_INT["ring"], **out["ref"][1],
              "captures": captures, "cuda_equals_cpu_ref": same,
              "first_difference": differ})
        if not same or captures > 1:
            raise AssertionError(f"ring {overload}: card vs CPU ref mode "
                                 f"{differ}, {captures} captures")
        if (overload == "shed") != (out["ref"][1]["shed"] > 0):
            raise AssertionError(f"ring {overload}: shed "
                                 f"{out['ref'][1]['shed']}")
    emit({"phase": "routed", "index": "integer", "host_build_s": build_s})
    return ri


def build_routed_sift():
    """The sift-1b stand-in's routed build on the host (CPU tensors):
    (RoutedIndex, host seconds). Run in a child process (``spawn``)
    while the earlier phases use the card."""
    from repro_torch.core.router import build_routed_index
    from repro_torch.launch.search import dataset
    t0 = time.perf_counter()
    ri = build_routed_index(dataset("sift-1b").materialize(), shards=SHARDS,
                            page_size=PAGE, r=DEGREE,
                            centroids_per_shard=ROUTED["centroids"],
                            pref_width=ROUTED["spec"], device="cpu")
    return ri, time.perf_counter() - t0


def build_churn_sift():
    """Phase live's churn build: the sift-1b stand-in's first CHURN["n"]
    vectors built as phase main's are: (reordered vectors, packed index,
    host seconds)."""
    from repro_torch.launch.search import build_index, dataset
    t0 = time.perf_counter()
    db, packed = build_index(dataset("sift-1b").materialize()[:CHURN["n"]],
                             shards=SHARDS, page_size=PAGE, r=DEGREE,
                             pref_width=8)
    return db, packed, time.perf_counter() - t0


def start_host_builds():
    """Start :func:`build_main_sift`, :func:`build_routed_sift` and
    :func:`build_churn_sift` in a two-process spawn pool with two BLAS
    threads each (the host's other cores drive the card meanwhile);
    returns (pool, main build's async result, routed build's, churn
    build's). The caller terminates the pool."""
    import multiprocessing
    import os
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "OPENBLAS_NUM_THREADS")}
    os.environ.update({k: "2" for k in saved})
    try:
        pool = multiprocessing.get_context("spawn").Pool(2)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    return (pool, pool.apply_async(build_main_sift),
            pool.apply_async(build_routed_sift),
            pool.apply_async(build_churn_sift))


def routed_sift(dev, built) -> dict:
    """(b) The sift-1b stand-in as a routed build (``built``: the async
    result of :func:`start_routed_build`), served as the stream phase's
    Poisson stream at topr 2 and 8; topr 8 against the flat stream on
    the same index. Returns the topr-2 session's launches."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import EngineParams, pack_for_engine
    from repro_torch.core.graph import brute_force_topk, recall_at_k
    from repro_torch.core.metrics import stream_summary
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import (default_leg_L, poisson_arrivals,
                                            routed_stream_search,
                                            stream_search)
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset

    ds = dataset("sift-1b")
    t0 = time.perf_counter()
    ri, build_s = built.get()
    wait_s = time.perf_counter() - t0
    ri = routed_on(ri, dev)
    nq, slots = STREAM["queries"], STREAM["slots"]
    queries = ds.queries(nq, seed=1)
    arrivals = poisson_arrivals(STREAM["rate"], nq, seed=0)
    true_ids, _ = brute_force_topk(ri.db, queries, K)
    consts, geom, entry = pack_for_engine(ri.packed, device=dev)
    params = EngineParams.lossless(SearchParams(L=L, W=W, k=K), slots,
                                   DEGREE, spec_width=ROUTED["spec"],
                                   coalesce_qb=QB)

    def serve(topr, n=nq):
        return routed_stream_search(
            consts, geom, params, entry, queries[:n], router=ri.router,
            topr=topr, num_slots=slots, arrivals=arrivals[:n],
            round_chunk=STREAM["chunk"], injit_admit=True,
            shard_entries=ri.shard_entries, device=dev)

    res, keep = {}, {}
    for topr in ROUTED["toprs"]:
        R = 1 if topr >= SHARDS else topr
        reset_launch_counts()
        CACHE.reset_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dists, st = serve(topr)
        call_s = time.perf_counter() - t0
        launches = launch_counts()
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        summ = stream_summary(st)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ri.router.route(queries, topr)
        route_ms = (time.perf_counter() - t0) * 1e3
        prof, _, wall_ms, window = profiled_session(
            lambda m, topr=topr: serve(topr, m)[2], ROUTED["window"],
            [ProfilerActivity.CUDA])
        busy_ms, idle = idle_share(prof, wall_ms)
        del prof
        drop_traces()
        line = {"phase": "routed", "index": "sift-1b", "topr": topr,
                "legs_per_query": R,
                "leg_L": (params.search.L if R == 1 else max(K, default_leg_L(
                    geom.n // SHARDS, geom.max_degree, K))),
                "queries": nq, "slots_per_shard": slots,
                "arrival_rate": STREAM["rate"],
                "round_chunk": STREAM["chunk"], "spec": ROUTED["spec"],
                "recall@k": float(recall_at_k(ids, true_ids)),
                "qps": nq / st.wall_s, "wall_s": st.wall_s,
                "call_s": call_s, "warmup_s": st.compile_s,
                "route_ms": route_ms,
                "total_rounds": st.total_rounds, "legs": st.legs,
                "items_by_shard": st.items_by_shard,
                "mean_dists_per_query": sum(r.n_dist for r in st.results)
                / nq,
                "pages_unique": st.pages_unique,
                "latency_rounds": summ["latency_rounds"],
                "wall_latency_ms": summ["wall_latency_ms"],
                "occupancy": st.occupancy,
                "host_dispatches": st.host_dispatches, **cap,
                "host_ms_per_round": st.wall_s * 1e3 / st.total_rounds,
                "launches": {k: v for k, v in launches.items() if v},
                "launches_per_device_round": {
                    k: v / cap["device_rounds"] for k, v in launches.items()
                    if v},
                "profile_window": {**window, "wall_ms": wall_ms,
                                   "device_busy_ms": busy_ms,
                                   "device_idle_share": idle}}
        emit(line)
        routed_launches(f"routed sift topr {topr}", launches,
                        cap["device_rounds"], R)
        if cap["captures"] > 1 or st.host_syncs != st.host_dispatches:
            raise AssertionError(f"routed sift topr {topr}: {cap}, "
                                 f"{st.host_dispatches} chunks")
        res[topr] = line
        keep[topr] = (ids, dists, launches)
    ids_f, dists_f, st_f = stream_search(
        consts, geom, params, entry, queries, num_slots=slots,
        arrivals=arrivals, round_chunk=STREAM["chunk"], injit_admit=True,
        device=dev)
    ids8, dists8, _ = keep[SHARDS]
    rows = np.flatnonzero((ids8 != ids_f).any(1) | (
        dists8.view(np.int32) != dists_f.view(np.int32)).any(1))
    emit({"phase": "routed", "index": "sift-1b", "host_build_s": build_s,
          "build_wait_s": wait_s,
          "flat_stream": {"recall@k": float(recall_at_k(ids_f, true_ids)),
                          "qps": nq / st_f.wall_s,
                          "total_rounds": st_f.total_rounds,
                          "latency_rounds":
                              stream_summary(st_f)["latency_rounds"],
                          "wall_latency_ms":
                              stream_summary(st_f)["wall_latency_ms"],
                          "mean_dists_per_query": sum(
                              r.n_dist for r in st_f.results) / nq},
          f"topr{SHARDS}_rows_differing_from_flat": rows.tolist(),
          "topr2_dists_per_query_vs_flat":
              res[2]["mean_dists_per_query"]
              / (sum(r.n_dist for r in st_f.results) / nq)})
    if rows.size:
        raise AssertionError(f"routed topr {SHARDS}: rows {rows.tolist()} "
                             f"differ from the flat stream")
    return keep[2][2]


# ---------------------------------------------------------------------------
# Phase 7d: multi-device search on an engine mesh of one rank over NCCL
# ---------------------------------------------------------------------------
# seconds a collective may wait before the group raises: a hang fails the
# run instead of stalling it
MESH_TIMEOUT_S = 120


@contextlib.contextmanager
def mesh_group(dev):
    """A one-rank NCCL process group in this process (a loopback
    rendezvous on a free port, bound to ``dev``), as an engine mesh;
    destroyed on leaving."""
    import datetime
    import socket
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_engine_mesh
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S),
        device_id=dev)
    try:
        yield make_engine_mesh(num=1)
    finally:
        dist.destroy_process_group()


def nccl_split(prof) -> dict:
    """The card's device time in a torch.profiler run, the share of it
    in NCCL's kernels (the mesh's collectives), and the time in copies
    and fills (where a one-rank NCCL collective may go instead of a
    kernel: the mesh's count less the sim's)."""
    kern = device_kernel_us(prof)
    busy = sum(us for us, _ in kern.values())
    nccl = {k: v for k, v in kern.items() if "nccl" in k.lower()}
    nccl_us = sum(us for us, _ in nccl.values())
    copies = [v for k, v in kern.items() if k.startswith(("Memcpy",
                                                          "Memset"))]
    return {"device_busy_ms": busy / 1e3, "nccl_ms": nccl_us / 1e3,
            "nccl_share_of_device_time": nccl_us / busy if busy else None,
            "nccl_kernels": sorted(nccl),
            "nccl_launches": sum(c for _, c in nccl.values()),
            "copy_ms": sum(us for us, _ in copies) / 1e3,
            "copies": sum(c for _, c in copies)}


def mesh_integer(packed, queries, ri, dev) -> None:
    """(a) Phase int's integer index (and phase routed's integer routed
    build) on a one-rank NCCL mesh: search_distributed captured on the
    card equals the same run uncaptured, search_sim on the card and CPU
    ref mode; the mesh stream (refill, chunk 8, in-device admission,
    spec 4) and a routed mesh session at topr 2 equal their sim sessions
    on the card and CPU ref mode; one capture each, one distance and one
    fused merge per device round."""
    import numpy as np
    import torch
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                         search_distributed, search_sim,
                                         shard_consts)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import routed_stream_search, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts

    nq, slots = len(queries), 8
    qsh = queries.reshape(SHARDS, nq // SHARDS, -1)
    sp = SearchParams(L=32, W=1, k=10)
    arrivals = np.random.default_rng(3).integers(0, 64, nq)
    engines = {"cuda": pack_for_engine(packed, device=dev),
               "ref": pack_for_engine(packed, device="cpu")}
    where = {"cuda": dev, "ref": "cpu"}
    with mesh_group(dev) as mesh:
        out = {}
        for name, mode, on_mesh, capture in (
                ("mesh_captured", "cuda", True, True),
                ("mesh_uncaptured", "cuda", True, False),
                ("sim_captured", "cuda", False, True),
                ("cpu_ref", "ref", False, True)):
            consts, geom, entry = engines[mode]
            params = EngineParams.lossless(sp, nq // SHARDS, DEGREE,
                                           kernel_mode=mode)
            CACHE.reset_stats()
            reset_launch_counts()
            if on_mesh:
                res = search_distributed(shard_consts(consts, mesh), qsh,
                                         *entry, params, geom, mesh,
                                         device=where[mode], capture=capture)
            else:
                res = search_sim(consts, qsh, *entry, params, geom,
                                 device=where[mode], capture=capture)
            ids, dists, st = res
            out[name] = {"ids": ids.cpu(), "dists": dists.cpu().view(
                torch.int32), **{k: v.cpu() for k, v in st.items()
                                 if k != "host_syncs"}}
            if name == "mesh_captured":
                rounds = int(res[2]["total_rounds"].max())
                cap = capture_line(CACHE.stats, rounds, res[2]["host_syncs"])
                launches = launch_counts()
                entries = CACHE.count("search_distributed")
        differ = {name: [k for k in out["cpu_ref"]
                         if not torch.equal(out[name][k], out["cpu_ref"][k])]
                  for name in out}
        emit({"phase": "mesh", "index": "integer", "run": "search",
              "world": mesh.world, "backend": "nccl", "queries": nq,
              "rounds": rounds, **cap, "cache_entries": entries,
              "launches": {k: v for k, v in launches.items() if v},
              "bit_identical_to_cpu_ref": {
                  name: sorted(set(out["cpu_ref"]) - set(d))
                  for name, d in differ.items()}})
        if any(differ.values()):
            raise AssertionError(f"mesh search: differs from CPU ref mode: "
                                 f"{differ}")
        if cap["captures"] != 1 or entries != 1:
            raise AssertionError(f"mesh search: one capture expected: {cap}")
        check_launches("mesh search", launches, cap["device_rounds"])

        for run in ("stream", "routed_topr2"):
            out = {}
            for name, mode, on_mesh in (("mesh", "cuda", True),
                                        ("sim", "cuda", False),
                                        ("cpu_ref", "ref", False)):
                CACHE.reset_stats()
                reset_launch_counts()
                kw = dict(arrivals=arrivals, round_chunk=8, injit_admit=True,
                          mesh=mesh if on_mesh else None, device=where[mode])
                # a mesh rank passes its own shards' consts (at world 1
                # shard_consts gives back every shard's)
                mine = (lambda c: shard_consts(c, mesh)) if on_mesh \
                    else (lambda c: c)
                if run == "stream":
                    consts, geom, entry = engines[mode]
                    consts = mine(consts)
                    params = EngineParams.lossless(sp, slots, DEGREE,
                                                   spec_width=4,
                                                   kernel_mode=mode)
                    _, _, st = stream_search(consts, geom, params, entry,
                                             queries, num_slots=slots, **kw)
                else:
                    r = routed_on(ri, dev) if mode == "cuda" else ri
                    consts, geom, entry = pack_for_engine(r.packed,
                                                          device=where[mode])
                    consts = mine(consts)
                    params = EngineParams.lossless(sp, slots, DEGREE,
                                                   kernel_mode=mode)
                    _, _, st = routed_stream_search(
                        consts, geom, params, entry, queries, router=r.router,
                        topr=2, num_slots=slots,
                        shard_entries=r.shard_entries, **kw)
                out[name] = (stream_records(st, nq) | {
                    f: per_query(st, nq, f) for f in ("legs_fused",
                                                      "stall_rounds")},
                    {f: getattr(st, f) for f in (
                        "total_rounds", "host_dispatches", "legs",
                        "items_by_shard", "occupancy_trace")})
                if on_mesh:
                    launches, mesh_st = launch_counts(), st
                    cap = capture_line(CACHE.stats,
                                       st.total_rounds + st.warmup_rounds,
                                       st.host_syncs)
            differ = {name: first_difference(out[name][0], out["cpu_ref"][0])
                      or (None if out[name][1] == out["cpu_ref"][1]
                          else "counters") for name in ("mesh", "sim")}
            emit({"phase": "mesh", "index": "integer", "run": run,
                  "world": mesh.world, "queries": nq, "slots_per_shard": slots,
                  "round_chunk": 8, "injit_admit": True,
                  "total_rounds": out["cpu_ref"][1]["total_rounds"],
                  "host_dispatches": out["cpu_ref"][1]["host_dispatches"],
                  **cap, "launches": {k: v for k, v in launches.items() if v},
                  "first_difference_from_cpu_ref": differ})
            if any(differ.values()):
                raise AssertionError(f"mesh {run}: differs from CPU ref "
                                     f"mode: {differ}")
            if cap["captures"] != 1 or \
                    mesh_st.host_syncs != mesh_st.host_dispatches:
                raise AssertionError(f"mesh {run}: one capture and one read "
                                     f"per chunk expected: {cap}")
            if run == "stream":
                check_launches(f"mesh {run}", launches, cap["device_rounds"])
            else:
                routed_launches(f"mesh {run}", launches,
                                cap["device_rounds"], 2)


def mesh_sift(main: dict, static, dev) -> None:
    """(b) Phase main's sift-1b build on the one-rank NCCL mesh:
    search_distributed returns phase main's ids and dists, and the mesh
    stream session phase stream's refill static ids and dists. Printed
    beside the sim driver's, in turns on this card: QPS, syncs,
    captures, launches per device round, and a profiled window's device
    idle share and its NCCL share. At world 1 the collectives are pure
    overhead: no speed-up is claimed."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.capture import CACHE
    from repro_torch.core.engine import (EngineParams, search_distributed,
                                         search_sim, shard_consts)
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import poisson_arrivals, stream_search
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.search import dataset

    consts, geom, entry = main["engine"]
    params = EngineParams.lossless(SearchParams(L=L, W=W, k=K), NQ // SHARDS,
                                   DEGREE, coalesce_qb=QB)
    qsh = torch.as_tensor(main["queries"].reshape(SHARDS, NQ // SHARDS, -1),
                          device=dev)
    with mesh_group(dev) as mesh:
        mine = shard_consts(consts, mesh)
        drivers = {
            "mesh": lambda: search_distributed(mine, qsh, *entry, params,
                                               geom, mesh, device=dev),
            "sim": lambda: search_sim(consts, qsh, *entry, params, geom,
                                      device=dev)}
        for fn in drivers.values():
            fn()                                  # captures
        reset_launch_counts()
        CACHE.reset_stats()
        i, d, st = drivers["mesh"]()
        launches = launch_counts()
        rounds = int(st["total_rounds"].max())
        cap = capture_line(CACHE.stats, rounds, st["host_syncs"])
        same = torch.equal(i.cpu(), main["ids"]) and torch.equal(
            d.cpu().view(torch.int32), main["dists"].view(torch.int32))
        walls = {name: [] for name in drivers}
        for name in ("sim", "mesh", "mesh", "sim") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            drivers[name]()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
        # busy time from a profiled call, idle against the unprofiled
        # calls' mean wall time (as phase main's profile)
        prof_lines = {}
        for name, fn in drivers.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            split = nccl_split(prof)
            wall_ms = 1e3 * sum(walls[name]) / len(walls[name])
            prof_lines[name] = {**split, "wall_ms_unprofiled": wall_ms,
                                "device_idle_share":
                                    1.0 - split["device_busy_ms"] / wall_ms}
            del prof
            drop_traces()
        emit({"phase": "mesh", "index": "sift-1b", "run": "search",
              "world": mesh.world, "queries": NQ, "rounds": rounds,
              **cap, "launches": launches,
              "launches_per_device_round": {
                  k: v / cap["device_rounds"] for k, v in launches.items()},
              "qps": {name: [NQ / w for w in ws]
                      for name, ws in walls.items()},
              "profiled": prof_lines, "equals_phase_main": same})
        if not same:
            raise AssertionError("mesh sift-1b search: ids or dists differ "
                                 "from phase main's")
        check_launches("mesh sift-1b search", launches, cap["device_rounds"])

        nq, slots = STREAM["queries"], STREAM["slots"]
        queries = dataset("sift-1b").queries(nq, seed=1)
        arrivals = poisson_arrivals(STREAM["rate"], nq, seed=0)
        sparams = EngineParams.lossless(SearchParams(L=L, W=W, k=K), slots,
                                        DEGREE, spec_width=STREAM["spec"],
                                        coalesce_qb=QB)

        def serve(m, n=nq):
            return stream_search(consts if m is None else mine, geom,
                                 sparams, entry, queries[:n],
                                 num_slots=slots, arrivals=arrivals[:n],
                                 round_chunk=STREAM["chunk"],
                                 injit_admit=True, mesh=m, device=dev,
                                 **STREAM_RUNS["refill_static"])

        reset_launch_counts()
        CACHE.reset_stats()
        ids, dists, st = serve(mesh)
        launches = launch_counts()
        cap = capture_line(CACHE.stats, st.total_rounds + st.warmup_rounds,
                           st.host_syncs)
        same = np.array_equal(ids, static[0]) and np.array_equal(
            dists.view(np.int32), static[1].view(np.int32))
        sessions = {"mesh": [], "sim": []}
        for name in ("sim", "mesh", "mesh", "sim"):
            sessions[name].append(serve(mesh if name == "mesh" else None)[2])
        windows = {}
        for name in ("mesh", "sim"):
            prof, wst, wall_ms, wcap = profiled_session(
                lambda n, name=name: serve(mesh if name == "mesh" else None,
                                           n)[2],
                STREAM["window"], [ProfilerActivity.CUDA])
            split = nccl_split(prof)
            windows[name] = {**wcap, **split, "queries": STREAM["window"],
                             "wall_ms": wall_ms, "device_idle_share":
                                 1.0 - split["device_busy_ms"] / wall_ms}
            del prof
            drop_traces()
        emit({"phase": "mesh", "index": "sift-1b", "run": "stream",
              "world": mesh.world, "queries": nq, "slots_per_shard": slots,
              "arrival_rate": STREAM["rate"], "round_chunk": STREAM["chunk"],
              "spec": STREAM["spec"], "total_rounds": st.total_rounds,
              "host_dispatches": st.host_dispatches, **cap,
              "launches": launches,
              "launches_per_device_round": {
                  k: v / cap["device_rounds"] for k, v in launches.items()},
              "qps": {name: [nq / s.wall_s for s in ss]
                      for name, ss in sessions.items()},
              "host_ms_per_round": {
                  name: [s.wall_s * 1e3 / s.total_rounds for s in ss]
                  for name, ss in sessions.items()},
              "profile_window": windows,
              "equals_phase_stream_refill_static": same})
        if not same:
            raise AssertionError("mesh sift-1b stream: ids or dists differ "
                                 "from phase stream's refill static session")
        check_launches("mesh sift-1b stream", launches, cap["device_rounds"])
        if st.host_syncs != st.host_dispatches or cap["captures"] > 1:
            raise AssertionError(f"mesh sift-1b stream: one read per chunk "
                                 f"and at most one capture expected: {cap}")


# ---------------------------------------------------------------------------
# Phase 4: flash attention against its plain version
# ---------------------------------------------------------------------------
# gemma3-1b's prefill geometry: B 4, H 4, Hkv 1, S 1024, dh 256; layers
# 5, 11, 17 and 23 of its 26 are global (window 0), the rest local (512)
G3 = dict(B=4, H=4, Hkv=1, S=1024, dh=256)
GLOBAL_LAYERS = 4


# the other families' prefill attentions (full width): mixtral's layers
# (GQA 32/8, dh 128, window 4096), zamba2's shared block (dh 64, window
# 4096), seamless's encoder (non-causal), decoder self-attention and
# cross-attention (non-causal over the encoder's frames)
MIXTRAL_ATTN = dict(B=4, H=32, Hkv=8, S=1024, dh=128)
ZAMBA2_ATTN = dict(B=4, H=32, Hkv=32, S=1024, dh=64)
SEAMLESS_ATTN = dict(B=4, H=16, Hkv=16, S=1024, dh=64)


def qkv(B, H, Hkv, S, dh, dtype, dev, seed: int, Skv: int = 0):
    """Random q (B,H,S,dh) and k, v (B,Hkv,Skv,dh) (Skv 0 -> S)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    Skv = Skv or S
    return tuple((0.5 * torch.randn(shape, generator=g, device=dev)).to(dtype)
                 for shape in ((B, H, S, dh), (B, Hkv, Skv, dh),
                               (B, Hkv, Skv, dh)))


def check_attention(dev) -> float:
    """Every case within ATTN_TOL (|err| <= tol + tol |ref|); returns the
    worst f32 max abs error."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_op,
                                                     attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import KERNEL
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (
        ("gemma3 local, window 512", G3, f32, dict(window=512), False),
        ("gemma3 global, full", G3, f32, dict(window=0), False),
        ("gemma2-like softcap 50", dict(B=1, H=32, Hkv=16, S=1024, dh=128),
         f32, dict(softcap=50.0), False),
        ("gemma3 bf16, window 512", G3, bf16, dict(window=512), False),
        ("gemma3 S=1000 through attention_op", dict(G3, S=1000), f32,
         dict(window=512), True),
        ("gemma3 S=992 (a half q block), window 40", dict(G3, S=992), f32,
         dict(window=40), False),
        ("gemma3 non-causal", G3, f32, dict(causal=False), False),
        ("mixtral prefill (GQA 32/8, dh 128), window 4096", MIXTRAL_ATTN,
         f32, dict(window=4096), False),
        ("zamba2 shared block (dh 64), window 4096", ZAMBA2_ATTN, f32,
         dict(window=4096), False),
        ("seamless encoder (dh 64), non-causal", SEAMLESS_ATTN, f32,
         dict(causal=False), False),
        ("seamless decoder self-attention (dh 64), causal", SEAMLESS_ATTN,
         f32, dict(window=0), False),
        ("seamless cross-attention through attention_op, Skv 1024",
         dict(SEAMLESS_ATTN, Skv=1024), f32,
         dict(causal=False, kv_valid=1024), True),
        ("seamless cross-attention through attention_op, Skv 1088 padded, "
         "kv_valid 1000", dict(SEAMLESS_ATTN, Skv=1088), f32,
         dict(causal=False, kv_valid=1000), True),
    )
    worst = 0.0
    for i, (label, shp, dtype, kw, through_op) in enumerate(cases):
        q, k, v = qkv(**shp, dtype=dtype, dev=dev, seed=11 + i)
        scale = shp["dh"] ** -0.5
        before = KERNEL.launches
        if through_op:
            out = attention_op(q, k, v, scale=scale, mode="cuda", **kw)
        else:
            out = flash_attention(q, k, v, scale=scale, **kw)
        # the plain version over the valid kv rows only: an independent
        # check of the kernel's valid-length mask
        ref_kw = {n: x for n, x in kw.items() if n != "kv_valid"}
        valid = kw.get("kv_valid") or k.shape[2]
        ref = attention_ref(q, k[:, :, :valid], v[:, :, :valid],
                            scale=scale, **ref_kw).float()
        torch.cuda.synchronize()
        if KERNEL.launches != before + 1 or out.dtype != dtype:
            raise AssertionError(f"flash_attention {label}: the kernel did "
                                 f"not run once in {dtype}")
        err = (out.float() - ref).abs()
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        max_abs = float(err.max())
        max_rel = max_abs / float(ref.abs().max())
        ok = bool((err <= tol + tol * ref.abs()).all()) and \
            bool(torch.isfinite(out).all())
        emit({"phase": "attn_kernels", "kernel": "flash_attention",
              "case": label, **shp, "dtype": str(dtype), **kw,
              "max_abs_err": max_abs, "max_rel_err": max_rel,
              "tolerance": f"atol {tol} + rtol {tol}", "ok": ok})
        if not ok:
            raise AssertionError(f"flash_attention {label}: error "
                                 f"{max_abs} beyond tolerance {tol}")
        if dtype == f32:
            worst = max(worst, max_abs)
        del q, k, v, out, ref, err
    return worst


def check_attention_bwd(dev) -> float:
    """The training path's pair on the card: the forward with its lse and
    the backward kernel, per case, against the plain versions on the
    same inputs: out and lse against attention_fwd_ref (|err| <= tol +
    tol |ref|), dq, dk, dv against attention_bwd_ref on the kernel's own
    out and lse (|err| <= tol x max |ref| of that gradient); tol is
    ATTN_TOL of the dtype. Cases marked "op" run attention_op under
    autograd (FlashAttentionFn). Also: the backward twice gives the same
    bits (no atomics), and the serving launch (no lse) gives the lse
    launch's output bit for bit. Returns the worst f32 gradient max abs
    error."""
    import torch
    from repro_torch.kernels.flash_attention import attention_op
    from repro_torch.kernels.flash_attention.kernel import (
        BWD_KERNEL, KERNEL, flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_fwd_ref)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = (
        ("gemma3 local, window 512", G3, f32, dict(window=512), False),
        ("gemma3 global, full", G3, f32, dict(window=0), False),
        ("gemma2-like softcap 50 (dh 128)",
         dict(B=1, H=32, Hkv=16, S=1024, dh=128), f32, dict(softcap=50.0),
         False),
        ("gemma3 bf16, window 512", G3, bf16, dict(window=512), False),
        ("gemma3 S=992, window 40, through attention_op", dict(G3, S=992),
         f32, dict(window=40), True),
        ("gemma3 non-causal", G3, f32, dict(causal=False), False),
        ("seamless cross through attention_op, Skv 1088 padded, kv_valid "
         "1000", dict(SEAMLESS_ATTN, Skv=1088), f32,
         dict(causal=False, kv_valid=1000), True),
        ("dh 64 (GQA 8/2), window 100", dict(B=2, H=8, Hkv=2, S=512, dh=64),
         f32, dict(window=100), False),
        ("dh 16 (GQA 8/2), causal", dict(B=2, H=8, Hkv=2, S=512, dh=16), f32,
         dict(window=0), False),
        # the shapes phase train_mesh's part families gives the pair
        # (batch 2 x 1024, full width, f32)
        ("zamba2 shared block, training, window 4096, through "
         "attention_op", dict(ZAMBA2_ATTN, B=2), f32, dict(window=4096),
         True),
        ("seamless decoder self-attention, training, causal, through "
         "attention_op", dict(SEAMLESS_ATTN, B=2), f32, dict(window=0),
         True),
        ("seamless encoder and cross-attention, training, non-causal, "
         "through attention_op", dict(SEAMLESS_ATTN, B=2), f32,
         dict(causal=False), True),
    )
    worst = 0.0
    for i, (label, shp, dtype, kw, through_op) in enumerate(cases):
        q, k, v = qkv(**shp, dtype=dtype, dev=dev, seed=41 + i)
        g = torch.Generator(device=dev).manual_seed(61 + i)
        dout = torch.randn(q.shape, generator=g, device=dev).to(dtype)
        scale = shp["dh"] ** -0.5
        kern_kw = dict(scale=scale, causal=kw.get("causal", True),
                       window=kw.get("window", 0),
                       softcap=kw.get("softcap", 0.0),
                       s_orig=kw.get("kv_valid", 0))
        before = (KERNEL.launches, BWD_KERNEL.launches)
        out, lse = flash_attention(q, k, v, return_lse=True, **kern_kw)
        if through_op:
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            y = attention_op(*leaves, scale=scale, mode="cuda", **kw)
            y.backward(dout)
            grads = [x.grad for x in leaves]
            same_out = torch.equal(y.detach(), out)
        else:
            grads = flash_attention_bwd(q, k, v, out, lse, dout, **kern_kw)
            same_out = True
        ref_out, ref_lse = attention_fwd_ref(q, k, v, **kern_kw)
        ref = attention_bwd_ref(q, k, v, out, lse, dout, **kern_kw)
        torch.cuda.synchronize()
        want = (before[0] + 1 + through_op, before[1] + 1)
        if (KERNEL.launches, BWD_KERNEL.launches) != want or \
                any(x.dtype != dtype for x in grads):
            raise AssertionError(f"flash_attention_bwd {label}: the kernels "
                                 f"did not run as expected in {dtype}")
        tol = ATTN_TOL[str(dtype).split(".")[-1]]
        out_err = float((out.float() - ref_out.float()).abs().max())
        lse_err = (lse - ref_lse).abs()
        line = {"phase": "attn_kernels", "kernel": "flash_attention_bwd",
                "case": label, **shp, "dtype": str(dtype), **kw,
                "through_attention_op": through_op,
                "out_err": out_err, "lse_max_abs_err": float(lse_err.max()),
                "tolerance": f"out, lse: atol {tol} + rtol {tol}; grads: "
                             f"{tol} x max |ref|"}
        ok = bool((lse_err <= tol + tol * ref_lse.abs()).all()) and \
            bool(((out.float() - ref_out.float()).abs()
                  <= tol + tol * ref_out.float().abs()).all()) and same_out
        for name, a, b in zip(("dq", "dk", "dv"), grads, ref):
            err = float((a.float() - b.float()).abs().max())
            scale_ref = float(b.float().abs().max())
            line[f"{name}_max_abs_err"] = err
            line[f"{name}_max_abs"] = scale_ref
            ok = ok and err <= tol * scale_ref and \
                bool(torch.isfinite(a).all())
            if dtype == f32:
                worst = max(worst, err)
        if i == 0:
            # no atomics: a second run gives the same bits; the serving
            # launch (no lse) the same output
            again = flash_attention_bwd(q, k, v, out, lse, dout, **kern_kw)
            line["repeat_bit_equal"] = all(torch.equal(a, b)
                                           for a, b in zip(grads, again))
            line["serving_launch_bit_equal"] = torch.equal(
                flash_attention(q, k, v, **kern_kw), out)
            ok = ok and line["repeat_bit_equal"] and \
                line["serving_launch_bit_equal"]
        line["ok"] = ok
        emit(line)
        if not ok:
            raise AssertionError(f"flash_attention_bwd {label}: {line}")
        del q, k, v, out, lse, grads, ref, ref_out, ref_lse, dout
    return worst


# ---------------------------------------------------------------------------
# Phases 8 and 8b: every model family served through launch/serve.py
# ---------------------------------------------------------------------------
SERVE = dict(batch=4, prompt_len=1024, rag_dim=32, check_gen=4)
# (phase, arch, its published (layers, d_model, vocab), layers kept (None:
# all), --rag, flash launches per prefill, tokens generated)
SERVE_CASES = (
    ("serve", "gemma3-1b", (26, 1152, 262144), None, True, 26, 32),
    # 8 of 32 layers: one layer's experts are 8 x 3 x 4096 x 14336 f32
    # (5.6 GiB); 32 layers (~180 GiB) do not fit one 80 GB card
    ("serve_families", "mixtral-8x7b", (32, 4096, 32000), 8, True, 8, 16),
    # depth cut to keep the script inside its limit on slow hosts (the
    # decode of every layer is host-bound): 24 of 48 layers
    ("serve_families", "mamba2-780m", (48, 1536, 50280), 24, False, 0, 16),
    # 20 of 38 layers: 3 shared-block applications and a 2-layer SSD tail,
    # as the full model's 6 and 2
    ("serve_families", "zamba2-1.2b", (38, 2048, 32000), 20, True, 3, 16),
    # 12 encoder + 12 decoder self + 12 cross
    ("serve_families", "seamless-m4t-medium", (12, 1024, 256206), None,
     False, 36, 16),
)
# prefill + decode against the full forward (tests/test_models_decode.py)
DECODE_TOL = 5e-3


def near_tie_divergence(out, ref_out, stats, ref_stats, tol):
    """None if the greedy tokens are equal, else the first differing
    (row, step) with both runs' top-2 logit gap there; raises unless the
    gap is within ``tol`` (only a near-tie may flip a greedy pick)."""
    differ = (out != ref_out).cpu().numpy()
    if not differ.any():
        return None
    step = int(differ.any(0).argmax())
    row = int(differ[:, step].argmax())
    gap = min(float(stats["top2_gap"][row, step]),
              float(ref_stats["top2_gap"][row, step]))
    divergence = {"row": row, "step": step, "top2_gap": gap}
    if gap > tol:
        raise AssertionError(f"greedy tokens diverge at {divergence}, not "
                             f"a near-tie (tolerance {tol})")
    return divergence


def retrieval_vs_cpu(cfg, rag, k: int, index) -> dict:
    """The card's retrieval against the same retrieval with the plain
    versions on the CPU: ids agree except inside a real-valued near-tie
    of distances (the kernel and the CPU sum in different orders)."""
    from repro_torch.launch.serve import soft_prompt_from_retrieval
    _, cpu_ids, cpu_dists = soft_prompt_from_retrieval(
        cfg, rag["queries"], k=k, kernel_mode="ref", device="cpu",
        index=index)
    dist_err = abs(rag["dists"] - cpu_dists)
    if not (dist_err <= 1e-5 * abs(cpu_dists) + 1e-5).all():
        raise AssertionError(f"{cfg.name} retrieval: card and CPU disagree "
                             f"(ids {rag['ids']} vs {cpu_ids})")
    return {"retrieved_ids": rag["ids"].tolist(),
            "retrieval_dist_err_vs_cpu": float(dist_err.max()),
            "retrieval_ids_differ_vs_cpu": int((rag["ids"] != cpu_ids).sum())}


def decode_vs_forward(params, cfg, tokens, out, fe, enc_len: int, dev):
    """Prefill + decode against logits_fn over the longer sequence (moe
    at capacity factor E: decode buckets B tokens, prefill B x Sp), held
    to the reference test's 5e-3 and to LOGIT_RTOL x max |logit|.
    Returns the line's fields."""
    import torch
    from repro_torch.models import transformer as T

    B, Sp = tokens.shape
    check_gen = SERVE["check_gen"]
    e_opts = T.ModelOpts(cap_factor=float(max(cfg.num_experts, 1)))
    seq = torch.cat([tokens, out[:, :check_gen].long()], dim=1)
    full, _ = T.logits_fn(params, cfg, seq, opts=e_opts, frontend_embeds=fe)
    cache = T.init_cache(cfg, B, Sp + check_gen, enc_len=max(enc_len, 1),
                         dtype=torch.float32, device=dev)
    lg, cache = T.prefill(params, cfg, tokens, cache, opts=e_opts,
                          frontend_embeds=fe)
    steps = [lg]
    for t in range(check_gen - 1):
        lg, cache = T.decode_step(params, cfg, cache,
                                  seq[:, Sp + t:Sp + t + 1], opts=e_opts)
        steps.append(lg)
    want = full[:, Sp - 1:Sp - 1 + check_gen].transpose(0, 1)
    gap = (torch.stack(steps) - want).abs()
    err = float(gap.max())
    scale_tol = LOGIT_RTOL * float(want.abs().max())
    if not (bool((gap <= DECODE_TOL + DECODE_TOL * want.abs()).all())
            and err <= scale_tol):
        raise AssertionError(f"{cfg.name}: prefill + decode differ from "
                             f"the full forward by {err} (scale bound "
                             f"{scale_tol})")
    return {"decode_vs_forward_err": err,
            "decode_vs_forward_tol": f"atol {DECODE_TOL} + rtol "
                                     f"{DECODE_TOL}, and {scale_tol}",
            "decode_check_cap_factor": e_opts.cap_factor}


def serve_case(dev, case, index, index_s: float) -> dict:
    """One SERVE_CASES entry at its published widths (``layers`` cuts the
    depth) through launch/serve.py's functions: checks and one line (see
    the module docstring, phases 8 and 8b). Returns the kernels' launch
    counts of the timed generation."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis.capture_guard import CaptureGuard
    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.serve import (greedy_generate, make_step_fns,
                                          serve_inputs)
    from repro_torch.models import transformer as T

    phase, arch, widths, layers, rag, flash, gen = case
    t_start = time.perf_counter()
    cfg = get_config(arch)
    if (cfg.num_layers, cfg.d_model, cfg.vocab_size) != widths:
        raise AssertionError(f"{arch} is not at its published widths "
                             f"{widths}: {cfg}")
    reduced = []
    if layers is not None and layers < cfg.num_layers:
        reduced.append(f"num_layers {cfg.num_layers} -> {layers}")
        cfg = dataclasses.replace(cfg, num_layers=layers)
    B, Sp = SERVE["batch"], SERVE["prompt_len"]

    # the random weights and (rag) the retrieval stage: the search kernels
    reset_launch_counts()
    t0 = time.perf_counter()
    params, tokens, fe, rag_out = serve_inputs(
        cfg, batch=B, prompt_len=Sp, rag=rag, rag_dim=SERVE["rag_dim"],
        seed=0, device=dev, index=index)
    torch.cuda.synchronize()
    inputs_s = time.perf_counter() - t0
    inputs = launch_counts()
    retrieval = {}
    if rag:
        if not all(inputs[k] > 0 for k in SEARCH_KERNELS):
            raise AssertionError(f"{arch}: a search kernel did not launch "
                                 f"in the retrieval stage: {inputs}")
        retrieval = {"index_build_s": index_s,
                     **retrieval_vs_cpu(cfg, rag_out, fe.shape[1], index)}
    enc_len = Sp if cfg.frontend == "audio" else 0
    opts = T.ModelOpts()
    # the session: decode_step captured on the warm-up's first token,
    # replayed by every later one
    step_fns = make_step_fns(cfg, opts)
    with CaptureGuard() as cg_session:
        greedy_generate(params, cfg, tokens, gen=2, opts=opts,
                        frontend_embeds=fe, enc_len=enc_len,
                        step_fns=step_fns, cache_len=Sp + gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        stats = {}
        t0 = time.perf_counter()
        out = greedy_generate(params, cfg, tokens, gen=gen, opts=opts,
                              frontend_embeds=fe, enc_len=enc_len,
                              step_fns=step_fns, stats=stats,
                              keep_logits=True)
        wall_s = time.perf_counter() - t0
    generate = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # the eager twin: the same generation, decode_step run op by op
    eager_fns = make_step_fns(cfg, opts, capture=False)
    greedy_generate(params, cfg, tokens, gen=2, opts=opts,
                    frontend_embeds=fe, enc_len=enc_len, step_fns=eager_fns,
                    cache_len=Sp + gen)          # its cache, the allocator
    torch.cuda.synchronize()
    eager_stats = {}
    t0 = time.perf_counter()
    eager_out = greedy_generate(params, cfg, tokens, gen=gen, opts=opts,
                                frontend_embeds=fe, enc_len=enc_len,
                                step_fns=eager_fns, stats=eager_stats,
                                keep_logits=True)
    eager_wall_s = time.perf_counter() - t0
    if not torch.equal(out, eager_out):
        raise AssertionError(f"{arch}: the captured decode's tokens differ "
                             f"from the eager decode's")
    eager_logit_diff = float((stats.pop("logits")
                              - eager_stats.pop("logits")).abs().max())
    # one prefill launches `flash` kernels; the gen - 1 decode steps none
    if generate["flash_attention"] != flash or \
            any(generate[k] for k in SEARCH_KERNELS):
        raise AssertionError(f"{arch}: generation launched {generate}, "
                             f"expected {flash} flash_attention (the "
                             f"prefill's) and nothing else")
    if not stats["logits_finite"]:
        raise AssertionError(f"{arch}: non-finite logits")

    # the prefill's logits through the kernel against plain attention's
    ref_opts = T.ModelOpts(attn_mode="ref")
    logits = {}
    for mode, o in (("kernel", opts), ("plain", ref_opts)):
        cache = T.init_cache(cfg, B, Sp, enc_len=max(enc_len, 1),
                             dtype=torch.float32, device=dev)
        logits[mode], _ = T.prefill(params, cfg, tokens, cache, opts=o,
                                    frontend_embeds=fe)
    del cache
    logit_err = float((logits["kernel"] - logits["plain"]).abs().max())
    logit_scale = float(logits["plain"].abs().max())
    logit_tol = LOGIT_RTOL * logit_scale
    del logits
    if not logit_err <= logit_tol:
        raise AssertionError(f"{arch}: prefill logits differ by "
                             f"{logit_err} > {logit_tol}")
    ref_stats = {}
    ref_out = greedy_generate(params, cfg, tokens, gen=gen, opts=ref_opts,
                              frontend_embeds=fe, enc_len=enc_len,
                              stats=ref_stats)
    divergence = near_tie_divergence(out, ref_out, stats, ref_stats,
                                     logit_tol)
    decode_check = decode_vs_forward(params, cfg, tokens, out, fe, enc_len,
                                     dev)
    aux = {}
    if cfg.family == "moe":      # the serving capacity factor's routing
        _, aux = T.forward_hidden(params, cfg, tokens, opts=opts,
                                  frontend_embeds=fe)
        aux = {k: float(v) for k, v in aux.items()}

    # the card's busy time: one prefill, then one whole generation each
    # way, then one decode step each way with host activity (the
    # session's, a replay: one graph launch; the eager twin's: what
    # Python issues per token), on the sessions' caches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cache = T.init_cache(cfg, B, Sp + gen, enc_len=max(enc_len, 1),
                             dtype=torch.float32, device=dev)
        _, cache = T.prefill(params, cfg, tokens, cache, opts=opts,
                             frontend_embeds=fe)
        torch.cuda.synchronize()
    pre = device_kernel_us(prof)
    whole, steps = {}, {}
    with CaptureGuard() as cg_replays:
        for way, fns in (("captured", step_fns), ("eager", eager_fns)):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                greedy_generate(params, cfg, tokens, gen=gen, opts=opts,
                                frontend_embeds=fe, enc_len=enc_len,
                                step_fns=fns)
                torch.cuda.synchronize()
            whole[way] = device_kernel_us(prof)
            c = fns.cache(B, Sp + gen, max(enc_len, 1), dev)
            _, c = fns.prefill(params, tokens, c, fe)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fns.decode(params, c, out[:, -1:])
                torch.cuda.synchronize()
            steps[way] = prof.key_averages()
            del c
    captures = cg_session.count("decode_step") + \
        cg_replays.count("decode_step")
    if cg_session.count("decode_step") != 1 or cg_replays.total:
        raise AssertionError(f"{arch}: decode_step captures {cg_session.names}"
                             f" in the session's generations and "
                             f"{cg_replays.names} in its replays, expected "
                             f"one and none")
    step_fns.close()
    eager_fns.close()

    def api_calls(step, names):
        return sum(e.count for e in step if e.key in names)
    graph_launches = {w: api_calls(st, ("cudaGraphLaunch",))
                      for w, st in steps.items()}
    kernel_launches = {w: api_calls(st, ("cudaLaunchKernel",
                                         "cuLaunchKernel",
                                         "cudaLaunchKernelExC"))
                       for w, st in steps.items()}
    host_top = sorted(steps["eager"],
                      key=lambda e: -e.self_cpu_time_total)[:5]
    drop_traces()
    pre_ms = sum(us for us, _ in pre.values()) / 1e3
    whole_ms = {w: sum(us for us, _ in v.values()) / 1e3
                for w, v in whole.items()}
    prefill_ms, decode_ms = stats["prefill_s"] * 1e3, stats["decode_s"] * 1e3
    eager_decode_ms = eager_stats["decode_s"] * 1e3
    top = sorted(pre.items(), key=lambda kv: -kv[1][0])[:6]
    emit({"phase": phase, "arch": cfg.name, "family": cfg.family,
          "layers": cfg.num_layers, "reduced": reduced,
          "d_model": cfg.d_model, "vocab": cfg.vocab_size, "batch": B,
          "prompt_len": Sp, "gen": gen,
          "rag_k": int(fe.shape[1]) if rag else 0,
          "frontend": cfg.frontend, **retrieval, "inputs_s": inputs_s,
          "params_gib": sum(x.numel() * x.element_size()
                            for x in params.parameters()) / 2**30,
          "tok_s": B * gen / wall_s, "wall_s": wall_s,
          "prefill_ms": prefill_ms,
          "decode_ms_per_token": decode_ms / (gen - 1),
          "decode_ms_per_token_eager": eager_decode_ms / (gen - 1),
          "prefill_ms_eager_run": eager_stats["prefill_s"] * 1e3,
          "wall_s_eager": eager_wall_s,
          "decode_step_captures": captures,
          "tokens_equal_eager": True,
          "logits_max_diff_vs_eager": eager_logit_diff,
          "graph_launches_per_token": graph_launches,
          "kernel_launches_per_token": kernel_launches,
          "peak_mem_gib": peak_gib,
          "launches": {"inputs": inputs, "generate": generate},
          "flash_launches_per_prefill": generate["flash_attention"],
          "prefill_logit_err": logit_err, "logit_scale": logit_scale,
          "logit_tolerance": logit_tol,
          "tokens_equal_plain_attention": divergence is None,
          "divergence": divergence,
          "min_top2_gap": float(stats["top2_gap"].min()),
          **decode_check,
          "prefill_device_busy_ms": pre_ms,
          "prefill_idle_share": 1.0 - pre_ms / prefill_ms,
          "prefill_flash_ms": sum(us for n, (us, _) in pre.items()
                                  if "flash_attention" in n) / 1e3,
          "generate_device_busy_ms": whole_ms["captured"],
          "generate_device_busy_ms_eager": whole_ms["eager"],
          "generate_idle_share": 1.0 - whole_ms["captured"] / (wall_s * 1e3),
          "decode_idle_share": 1.0 - (whole_ms["captured"] - pre_ms)
          / decode_ms,
          "decode_idle_share_eager": 1.0 - (whole_ms["eager"] - pre_ms)
          / eager_decode_ms,
          "decode_step_kernel_launches": kernel_launches["eager"],
          "decode_step_host_top": [
              {"name": e.key[:60], "self_cpu_ms": e.self_cpu_time_total / 1e3,
               "count": e.count} for e in host_top],
          "prefill_top": [{"name": n[:80], "ms": us / 1e3, "count": c}
                          for n, (us, c) in top],
          "sample": out[0, :16].tolist(), **aux,   # moe: drop_frac, lb_loss
          "seconds": round(time.perf_counter() - t_start, 2)})
    del params, tokens, fe, cache, out, ref_out, eager_out
    gc.collect()
    torch.cuda.empty_cache()
    return generate


def serve_phases(dev) -> dict:
    """Phases 8 and 8b: every SERVE_CASES entry in turn over one
    retrieval index (each frees its weights before the next). Returns
    gemma3-1b's generation launch counts."""
    from repro_torch.launch.serve import retrieval_index
    t0 = time.perf_counter()
    index = retrieval_index(SERVE["rag_dim"])
    index_s = time.perf_counter() - t0
    counts = {case[1]: serve_case(dev, case, index, index_s)
              for case in SERVE_CASES}
    return counts["gemma3-1b"]


# ---------------------------------------------------------------------------
# Phase 8c: training gemma3-1b at full width through launch/train.py
# ---------------------------------------------------------------------------
# the training cell: gemma3-1b (hf google/gemma-3-1b-pt) at full width,
# f32 weights from the seed, batch 4 x sequence 1024 (the flash rows'
# attention shape), remat full, loss chunk 512, AdamW lr 3e-4, warmup 5
TRAIN = dict(arch="gemma3-1b", batch=4, seq=1024, steps=10, lr=3e-4,
             warmup=5, loss_chunk=512)
# phase plan: one train_4k cell per family, and the five full-attention
# archs whose long_500k cell the plan skips
PLAN_CELLS = ("mamba2-780m", "zamba2-1.2b", "mixtral-8x7b",
              "llava-next-mistral-7b", "seamless-m4t-medium", "gemma3-1b")
# one host process beside the sift-1b builds' two: done (about 80 s of
# work) while the integer phases run, at the least cost to them
PLAN_WORKERS = 1
PLAN_SKIPS = ("dbrx-132b", "llama3-405b", "llava-next-mistral-7b",
              "seamless-m4t-medium", "yi-34b")
# the planned train step's operations against the cost model's count of
# the same step on the card (one op stream: only the devices differ)
PLAN_FLOPS_RTOL = 0.01
# one step through the kernels against the same step with plain
# attention on the card: the loss and the global gradient norm
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GNORM_RTOL = 1e-4
# the restart drill: reduced gemma3-1b, 12 steps, a failure at step 7,
# checkpoints every 5 steps
DRILL = dict(steps=12, fail_at=7, ckpt_every=5, batch=4, seq=128)
# the backward's CUDA kernels, as the profiler names them
BWD_KERNEL_NAMES = ("bwd_dq_kernel", "bwd_dkdv_kernel")
# part dots: phase train's cell under --remat dots, in the same process;
# every step's loss and grad norm against the full run's same step (the
# schedule of steps 0-5 does not depend on the run's length)
TRAIN_DOTS = dict(steps=6, mesh_steps=3)


def train_args(**over):
    """launch/train.py's flags for the training cell."""
    from repro_torch.launch.train import parse_args
    t = dict(TRAIN, **over)
    argv = ["--arch", t["arch"], "--steps", str(t["steps"]),
            "--batch", str(t["batch"]), "--seq", str(t["seq"]),
            "--lr", str(t["lr"]), "--warmup", str(t["warmup"]),
            "--remat", t.get("remat", "full"),
            "--loss-chunk", str(t["loss_chunk"]),
            "--log-every", "1", "--seed", "0"]
    if t.get("reduced"):
        argv.append("--reduced")
    if t.get("mesh"):
        argv += ["--mesh", t["mesh"], "--init-method", t["init_method"]]
    if t.get("ckpt_dir"):
        argv += ["--ckpt-dir", t["ckpt_dir"], "--ckpt-every",
                 str(t["ckpt_every"])]
    return parse_args(argv)


def model_flops(cfg, params: int, batch: int, seq: int) -> float:
    """A training step's model operations: 6 per parameter per token (the
    tied embedding once, as the unembedding's product), plus attention's
    4 dh per unmasked (row, col) pair and head, forward and backward
    (x 3); remat's recomputed forward not counted."""
    pairs = sum(attn_pairs(seq, True, w) for w in cfg.layer_windows())
    attn = 3 * 4 * cfg.head_dim * pairs * batch * cfg.num_heads
    return 6.0 * params * batch * seq + attn


def train_step_vs_plain(dev) -> dict:
    """(a) One step's loss and gradients of gemma3-1b at the training
    shape through the kernels against the same step with attn_mode
    "ref" (plain attention, differentiated by autograd) on the card:
    same parameters, same batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import ModelOpts
    from repro_torch.optim import OptConfig, global_norm
    from repro_torch.train.trainer import (TrainConfig, compute_grads,
                                           init_train_state)
    from repro_torch.utils import tree_leaves
    cfg = get_config(TRAIN["arch"])
    params, _ = init_train_state(cfg, OptConfig(),
                                 torch.Generator(device=dev).manual_seed(0))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"], 0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}
    out = {}
    for mode in ("auto", "ref"):
        reset_launch_counts()
        loss, _, grads = compute_grads(
            params, cfg, batch, TrainConfig(),
            ModelOpts(attn_mode=mode, loss_chunk=TRAIN["loss_chunk"]))
        out[mode] = (float(loss), float(global_norm(grads)),
                     tree_leaves(grads), launch_counts())
    (loss_k, gn_k, g_k, launches), (loss_r, gn_r, g_r, _) = \
        out["auto"], out["ref"]
    leaf_rel = [float((a - b).norm() / b.norm().clamp_min(1e-30))
                for a, b in zip(g_k, g_r)]
    line = {"phase": "train", "part": "kernel step vs plain attention",
            "arch": cfg.name, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "loss_kernel": loss_k, "loss_plain": loss_r,
            "loss_rel_err": abs(loss_k - loss_r) / abs(loss_r),
            "grad_norm_kernel": gn_k, "grad_norm_plain": gn_r,
            "grad_norm_rel_err": abs(gn_k - gn_r) / gn_r,
            "worst_leaf_rel_err": max(leaf_rel),
            "tolerance": f"loss {TRAIN_LOSS_RTOL}, grad norm "
                         f"{TRAIN_GNORM_RTOL} (relative)",
            "launches": {k: v for k, v in launches.items() if v}}
    emit(line)
    if not (line["loss_rel_err"] <= TRAIN_LOSS_RTOL
            and line["grad_norm_rel_err"] <= TRAIN_GNORM_RTOL):
        raise AssertionError(f"train: the kernel step differs from plain "
                             f"attention's: {line}")
    return line


def train_run(dev) -> dict:
    """(b) and (c): TRAIN["steps"] steps of gemma3-1b through
    launch/train.py's loop (train()), the launches of every step
    checked, then one more step profiled. Returns the launch counts of
    the run."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import build, train
    from repro_torch.models.transformer import ModelOpts, loss_fn

    layers = 26
    per_step, times, losses = [], [], []
    total = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        counts = launch_counts()
        per_step.append(counts)
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        reset_launch_counts()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    times.append(t0)
    run = train(train_args(), on_step=on_step)
    hist = run["history"]
    losses = [h["loss"] for h in hist]
    for i, counts in enumerate(per_step):
        want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
        got = {k: n for k, n in counts.items() if n}
        if got != want:
            raise AssertionError(f"train step {i} launched {got}, expected "
                                 f"{want} (26 forwards, 26 remat "
                                 f"recomputes, 26 backwards, no search "
                                 f"kernel)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_s = [b - a for a, b in zip(times, times[1:])]
    median_s = statistics.median(step_s[2:])      # steps 3..10
    # learning, without the batches' spread: step 0's batch again, through
    # the trained parameters
    cfg, _, step_fn, pipe, _ = build(train_args())
    params, opt = run["params"], run["opt"]
    with torch.no_grad():
        batch0 = {k: torch.as_tensor(v, device=dev)
                  for k, v in pipe.batch_at(0).items()}
        loss0_after = float(loss_fn(params, cfg, batch0, opts=ModelOpts(
            loss_chunk=TRAIN["loss_chunk"]))[0])
    reset_launch_counts()
    if not all(math.isfinite(x) for x in losses) or \
            any(h["skipped"] for h in hist) or not loss0_after < losses[0]:
        raise AssertionError(f"train: losses {losses}, skipped "
                             f"{[h['skipped'] for h in hist]}, step 0's "
                             f"batch after the run {loss0_after}")

    # (c) one more step, profiled: the device's busy time and top ops
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(TRAIN["steps"]).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step_fn(params, opt, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t1) * 1e3
    kern = device_kernel_us(prof)
    drop_traces()
    reset_launch_counts()
    busy_ms = sum(us for us, _ in kern.values()) / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    nparams = sum(p.numel() for p in params.parameters())
    flops = model_flops(cfg, nparams, TRAIN["batch"], TRAIN["seq"])
    tokens = TRAIN["batch"] * TRAIN["seq"]
    line = {"phase": "train", "part": "run", "arch": cfg.name,
            "params": nparams, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "steps": TRAIN["steps"], "lr": TRAIN["lr"],
            "warmup": TRAIN["warmup"], "loss_chunk": TRAIN["loss_chunk"],
            "remat": "full", "losses": losses,
            "last_below_first": losses[-1] < losses[0],
            "step0_batch_loss_before": losses[0],
            "step0_batch_loss_after": loss0_after,
            "grad_norms": [h["grad_norm"] for h in hist],
            "step_s": step_s, "ms_per_step_median_3_10": median_s * 1e3,
            "tokens_per_s": tokens / median_s, "peak_mem_gib": peak,
            "launches_per_step": per_step[-1],
            "model_tflop_per_step": flops / 1e12,
            "mfu_vs_67_tflops_f32": flops / median_s / F32_FLOPS,
            "profiled_step_wall_ms": wall_ms,
            "profiled_step_device_busy_ms": busy_ms,
            "profiled_step_idle_share": 1.0 - busy_ms / wall_ms,
            "profiled_step_flash_fwd_ms": sum(
                us for n, (us, _) in kern.items()
                if "flash_attention_kernel" in n) / 1e3,
            "profiled_step_flash_bwd_ms": sum(
                us for n, (us, _) in kern.items()
                if any(k in n for k in BWD_KERNEL_NAMES)) / 1e3,
            "profiled_step_top": [{"name": n[:80], "ms": us / 1e3, "count": c}
                                  for n, (us, c) in top]}
    emit(line)
    del run, params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    return total, line


def train_dots(dev, full_line: dict) -> dict:
    """(e) Phase train's cell under ``--remat dots`` (the products with
    no batch dimension kept, the rest recomputed), TRAIN_DOTS["steps"]
    steps through train() in this process: every step's loss and grad
    norm bit for bit the full run's same step, and the full run's flash
    launches per step (attention is recomputed under both); ms per step
    (median of steps 3-6), tokens/s and peak GiB beside the full run's."""
    import statistics

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    n, layers = TRAIN_DOTS["steps"], 26
    per_step, times = [], []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        per_step.append({k: v for k, v in launch_counts().items() if v})
        reset_launch_counts()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    times.append(time.perf_counter())
    run = train(train_args(steps=n, remat="dots"), on_step=on_step)
    hist = run["history"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    del run
    gc.collect()
    torch.cuda.empty_cache()
    step_s = [b - a for a, b in zip(times, times[1:])]
    median_s = statistics.median(step_s[2:])          # steps 3..6
    losses = [h["loss"] for h in hist]
    gnorms = [h["grad_norm"] for h in hist]
    want_l, want_g = full_line["losses"][:n], full_line["grad_norms"][:n]
    full_ms = full_line["ms_per_step_median_3_10"]
    line = {"phase": "train", "part": "dots", "arch": full_line["arch"],
            "batch": TRAIN["batch"], "seq": TRAIN["seq"], "steps": n,
            "remat": "dots", "losses": losses, "grad_norms": gnorms,
            "full_losses": want_l, "full_grad_norms": want_g,
            "bit_equal": losses == want_l and gnorms == want_g,
            "step_s": step_s, "ms_per_step_median_3_6": median_s * 1e3,
            "full_ms_per_step_median_3_10": full_ms,
            "ms_over_full": median_s * 1e3 / full_ms,
            "tokens_per_s": TRAIN["batch"] * TRAIN["seq"] / median_s,
            "full_tokens_per_s": full_line["tokens_per_s"],
            "peak_mem_gib": peak, "full_peak_mem_gib":
                full_line["peak_mem_gib"],
            "launches_per_step": per_step,
            "full_launches_per_step": full_line["launches_per_step"]}
    emit(line)
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
    if not line["bit_equal"] or any(x != want for x in per_step) or \
            any(h["skipped"] for h in hist):
        raise AssertionError(f"train: the dots run differs from the full "
                             f"run: {line}")
    return line


def restart_drill() -> dict:
    """(d), in a fresh process (``chip_smoke.py --restart-drill``, with
    CUBLAS_WORKSPACE_CONFIG set and deterministic algorithms on): reduced
    gemma3-1b trained DRILL["steps"] steps on the card without a break,
    then again under run_with_restarts with checkpoints every
    DRILL["ckpt_every"] steps and a failure injected at step
    DRILL["fail_at"]; the resumed run's parameters and optimizer state
    must equal the uninterrupted run's bit for bit."""
    import tempfile

    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.utils import as_tree, tree_leaves

    over = dict(reduced=True, steps=DRILL["steps"], batch=DRILL["batch"],
                seq=DRILL["seq"])
    reset_launch_counts()
    plain = train(train_args(**over))
    launches = {k: n for k, n in launch_counts().items() if n}
    failed = []

    def fail_injector(step):
        if step == DRILL["fail_at"] and not failed:
            failed.append(step)
            raise RuntimeError("injected node failure")

    with tempfile.TemporaryDirectory() as d:
        resumed = train(train_args(ckpt_dir=d, ckpt_every=DRILL["ckpt_every"],
                                   **over), fail_injector=fail_injector)
    pairs = list(zip(tree_leaves(as_tree(resumed["params"])),
                     tree_leaves(as_tree(plain["params"]))))
    opt_pairs = list(zip(tree_leaves(resumed["opt"]),
                         tree_leaves(plain["opt"])))
    return {"phase": "train", "part": "restart drill",
            "arch": "gemma3-1b reduced", **DRILL,
            "deterministic_algorithms":
                torch.are_deterministic_algorithms_enabled(),
            "restarts": resumed["restarts"], "failed_at": failed,
            "params_bit_equal": all(torch.equal(a, b) for a, b in pairs),
            "opt_bit_equal": all(torch.equal(a, b) for a, b in opt_pairs),
            "max_param_diff": max(float((a - b).detach().abs().max())
                                  for a, b in pairs),
            "final_loss": plain["history"][-1]["loss"],
            "launches_uninterrupted": launches}


def drill_in_child() -> dict:
    """Run :func:`restart_drill` in a fresh process: the cuBLAS workspace
    setting must be in place before the process's first CUDA call."""
    import os
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--restart-drill"], capture_output=True, text=True,
                         timeout=300, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"restart drill failed ({out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    emit(line)
    if not (line["params_bit_equal"] and line["opt_bit_equal"]
            and line["restarts"] == 1 and line["deterministic_algorithms"]):
        raise AssertionError(f"train: the resumed run differs from the "
                             f"uninterrupted one: {line}")
    return line


def train_phase(dev) -> dict:
    """Phase 8c: (a) the kernel step against plain attention, (b)-(c) the
    10-step run and a profiled step, (e) the dots run, (d) the restart
    drill in a child. Returns the run's launch counts and its line (the
    dots run's line under "dots")."""
    import torch
    timed_part("train", "kernel vs plain", train_step_vs_plain, dev)
    gc.collect()
    torch.cuda.empty_cache()
    total, line = timed_part("train", "run", train_run, dev)
    line["dots"] = timed_part("train", "dots", train_dots, dev, line)
    timed_part("train", "restart drill", drill_in_child)
    return total, line


def attn_pairs(S: int, causal: bool, window: int) -> int:
    """Unmasked (row, col) pairs of one (batch, head) at S = Skv."""
    from repro_torch.kernels.flash_attention.kernel import live_pairs
    return live_pairs(S, S, causal=causal, window=window)


# ---------------------------------------------------------------------------
# Phase 8c': the sharded training step at world 1 over NCCL
# ---------------------------------------------------------------------------
# phase train's cell through launch/train.py --mesh 1,1: its first steps
# (the learning rate's warmup: the same rates as phase train's 10-step
# run), each step's loss and grad norm held to phase train's
TRAIN_MESH = dict(steps=5, rtol=1e-6)
# the first MoE training on the card: mixtral-8x7b (hf
# mistralai/Mixtral-8x7B-v0.1) at full width, 1 of its 32 layers (1.7 B
# parameters, ~27 GB with AdamW in f32), batch 2 x 1024, 3 steps, against
# the unsharded make_train_step on the same seed and batches
MIXTRAL_TRAIN = dict(arch="mixtral-8x7b", layers=1, batch=2, seq=1024,
                     steps=3, lr=3e-4, warmup=5, loss_chunk=512)


def free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


# the SSD, hybrid and encoder-decoder families' first training on the
# card, at full width with their depth cut (config field -> depth):
# mamba2-780m (arXiv:2405.21060) 8 of 48 layers; zamba2-1.2b
# (arXiv:2411.15242) one hybrid group, 6 SSD layers and the shared
# block; seamless-m4t-medium (arXiv:2308.11596) 2 of 12 encoder and 2 of
# 12 decoder layers; batch 2 x 1024, 3 steps, unsharded and through
# --mesh 1,1, bit for bit
FAMILY_TRAIN = (("mamba2-780m", {"num_layers": 8}),
                ("zamba2-1.2b", {"num_layers": 6}),
                ("seamless-m4t-medium", {"num_layers": 2, "enc_layers": 2}))
FAMILY_STEPS = dict(batch=2, seq=1024, steps=3, lr=3e-4, warmup=5,
                    loss_chunk=512)


@contextlib.contextmanager
def depth_cut(**depth):
    """launch/train.py's configurations cut to at most ``depth``'s
    values of its fields (depth only: every width stays)."""
    import dataclasses
    from repro_torch.launch import train as train_mod
    real = train_mod.get_config

    def cut(name):
        cfg = real(name)
        return dataclasses.replace(cfg, **{
            k: min(v, getattr(cfg, k)) for k, v in depth.items()})
    train_mod.get_config = cut
    try:
        yield
    finally:
        train_mod.get_config = real


def mesh_train_run(args):
    """``train(args)`` with each step's wall seconds, launch counts and
    counted collectives, and the run's peak memory."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.train import train
    from repro_torch.train.parallel import STATS
    times, launches, colls = [], [], []

    def on_step(step, metrics):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        launches.append({k: n for k, n in launch_counts().items() if n})
        colls.append(STATS.rows())
        reset_launch_counts()
        STATS.reset()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    STATS.reset()
    times.append(time.perf_counter())
    run = train(args, on_step=on_step)
    hist = run["history"]
    out = {"losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "skipped": [h["skipped"] for h in hist],
           "step_ms": [1e3 * (b - a) for a, b in zip(times, times[1:])],
           "launches": launches, "collectives": colls,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    return run, out


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a)


def train_mesh_gemma(dev, train_line: dict) -> dict:
    """(a) Phase train's gemma3-1b cell through ``--mesh 1,1`` on a
    one-rank NCCL group: each step's loss and grad norm against phase
    train's same step (same seed, same batches), whether they are
    bit-equal, ms per step beside phase train's, the flash launches of
    every step, and the collectives the step launches: the counted ones
    (an axis of one rank launches none) and the NCCL kernels of a
    profiled step."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.train import build
    n = TRAIN_MESH["steps"]
    args = train_args(steps=n, mesh="1,1",
                      init_method=f"tcp://127.0.0.1:{free_port()}")
    run, out = mesh_train_run(args)
    # one more step on the same group, profiled: its NCCL kernels
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_train_group, make_train_mesh
    init_train_group(dev, init_method=f"tcp://127.0.0.1:{free_port()}",
                     rank=0, world=1)
    try:
        mesh = make_train_mesh((1, 1), device=dev)
        cfg, _, step_fn, pipe, _ = build(args, mesh)
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in pipe.batch_at(n).items()}
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step_fn(run["params"], run["opt"], batch)
            torch.cuda.synchronize()
        nccl = nccl_split(prof)
        drop_traces()
    finally:
        dist.destroy_process_group()
    want_l, want_g = train_line["losses"][:n], train_line["grad_norms"][:n]
    errs = [max(rel(a, b), rel(c, d)) for a, b, c, d in zip(
        out["losses"], want_l, out["grad_norms"], want_g)]
    layers = 26
    line = {"phase": "train_mesh", "part": "gemma3-1b world 1",
            "mesh": "1,1 (data, model) over nccl", "steps": n,
            "losses": out["losses"], "grad_norms": out["grad_norms"],
            "phase_train_losses": want_l, "phase_train_grad_norms": want_g,
            "max_rel_err": max(errs), "tolerance": TRAIN_MESH["rtol"],
            "bit_equal": out["losses"] == want_l
            and out["grad_norms"] == want_g,
            "step_ms": out["step_ms"],
            "ms_per_step_median_2_5": statistics.median(out["step_ms"][1:]),
            "phase_train_ms_per_step_median_3_10":
                train_line["ms_per_step_median_3_10"],
            "peak_gib": out["peak_gib"],
            "launches_per_step": out["launches"],
            "collectives_counted_per_step": [len(c) for c in
                                             out["collectives"]],
            "profiled_step_nccl": nccl}
    emit(line)
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
    if not line["max_rel_err"] <= TRAIN_MESH["rtol"] or \
            any(x != want for x in out["launches"]) or any(out["skipped"]):
        raise AssertionError(f"train_mesh: the world-1 mesh step differs "
                             f"from phase train's: {line}")
    del run
    return line


def train_mesh_dots(dev, train_line: dict) -> dict:
    """(d) Phase train's cell through ``--mesh 1,1 --remat dots``,
    TRAIN_DOTS["mesh_steps"] steps: each step's loss and grad norm bit
    for bit phase train's dots run's same step, its flash launches."""
    n, layers = TRAIN_DOTS["mesh_steps"], 26
    dots = train_line["dots"]
    run, out = mesh_train_run(train_args(
        steps=n, remat="dots", mesh="1,1",
        init_method=f"tcp://127.0.0.1:{free_port()}"))
    del run
    want_l, want_g = dots["losses"][:n], dots["grad_norms"][:n]
    line = {"phase": "train_mesh", "part": "gemma3-1b dots world 1",
            "mesh": "1,1 (data, model) over nccl", "remat": "dots",
            "steps": n, "losses": out["losses"],
            "grad_norms": out["grad_norms"], "one_device_losses": want_l,
            "one_device_grad_norms": want_g,
            "bit_equal": out["losses"] == want_l
            and out["grad_norms"] == want_g,
            "step_ms": out["step_ms"], "peak_gib": out["peak_gib"],
            "launches_per_step": out["launches"]}
    emit(line)
    want = {"flash_attention": 2 * layers, "flash_attention_bwd": layers}
    if not line["bit_equal"] or any(x != want for x in out["launches"]) \
            or any(out["skipped"]):
        raise AssertionError(f"train_mesh: the world-1 dots step differs "
                             f"from phase train's dots run: {line}")
    return line


def train_mesh_mixtral(dev) -> dict:
    """(b) mixtral-8x7b at full width cut to 1 layer, 3 steps unsharded
    and 3 steps through ``--mesh 1,1``: finite losses, equal within
    TRAIN_MESH["rtol"]; ms per step, peak GiB and the flash launches."""
    import torch
    t = MIXTRAL_TRAIN
    over = {k: t[k] for k in ("arch", "batch", "seq", "steps", "lr",
                              "warmup", "loss_chunk")}
    with depth_cut(num_layers=t["layers"]):
        plain_run, plain = mesh_train_run(train_args(**over))
        nparams = sum(p.numel() for p in plain_run["params"].parameters())
        del plain_run
        mesh_run, mesh = mesh_train_run(train_args(
            **over, mesh="1,1",
            init_method=f"tcp://127.0.0.1:{free_port()}"))
        del mesh_run
    gc.collect()
    torch.cuda.empty_cache()
    errs = [max(rel(a, b), rel(c, d)) for a, b, c, d in zip(
        mesh["losses"], plain["losses"], mesh["grad_norms"],
        plain["grad_norms"])]
    line = {"phase": "train_mesh", "part": "mixtral-8x7b world 1",
            "arch": t["arch"], "reduced": [f"num_layers 32 -> {t['layers']}"],
            "params": nparams, "batch": t["batch"], "seq": t["seq"],
            "steps": t["steps"], "mesh": "1,1 (data, model) over nccl",
            "losses": mesh["losses"], "grad_norms": mesh["grad_norms"],
            "unsharded_losses": plain["losses"],
            "unsharded_grad_norms": plain["grad_norms"],
            "max_rel_err": max(errs), "tolerance": TRAIN_MESH["rtol"],
            "bit_equal": mesh["losses"] == plain["losses"]
            and mesh["grad_norms"] == plain["grad_norms"],
            "step_ms": mesh["step_ms"], "unsharded_step_ms": plain["step_ms"],
            "peak_gib": mesh["peak_gib"],
            "unsharded_peak_gib": plain["peak_gib"],
            "launches_per_step": mesh["launches"],
            "collectives_counted_per_step": [len(c) for c in
                                             mesh["collectives"]]}
    emit(line)
    if not (all(math.isfinite(x) for x in mesh["losses"])
            and line["max_rel_err"] <= TRAIN_MESH["rtol"]
            and all(x.get("flash_attention_bwd", 0) == t["layers"]
                    for x in mesh["launches"])):
        raise AssertionError(f"train_mesh: mixtral's mesh run: {line}")
    return line


def train_mesh_families(dev) -> None:
    """(c) mamba2-780m, zamba2-1.2b and seamless-m4t-medium at full width
    (FAMILY_TRAIN's depths), 3 steps unsharded and 3 through ``--mesh
    1,1``: finite losses, bit-equal; ms per step, peak GiB and the flash
    forward and backward launches of every step (none for mamba2, whose
    SSD is plain torch; some for zamba2's shared block and seamless's
    encoder, decoder and cross-attention)."""
    import torch
    from repro_torch.configs import get_config
    over = dict(FAMILY_STEPS)
    for arch, depth in FAMILY_TRAIN:
        with depth_cut(**depth):
            plain_run, plain = mesh_train_run(train_args(arch=arch, **over))
            nparams = sum(p.numel()
                          for p in plain_run["params"].parameters())
            del plain_run
            mesh_run, mesh = mesh_train_run(train_args(
                arch=arch, **over, mesh="1,1",
                init_method=f"tcp://127.0.0.1:{free_port()}"))
            del mesh_run
        gc.collect()
        torch.cuda.empty_cache()
        fwd = [x.get("flash_attention", 0) for x in mesh["launches"]]
        bwd = [x.get("flash_attention_bwd", 0) for x in mesh["launches"]]
        line = {"phase": "train_mesh", "part": f"{arch} world 1",
                "arch": arch, "depth": depth, "params": nparams,
                "batch": over["batch"], "seq": over["seq"],
                "steps": over["steps"], "mesh": "1,1 (data, model) over nccl",
                "losses": mesh["losses"], "grad_norms": mesh["grad_norms"],
                "unsharded_losses": plain["losses"],
                "unsharded_grad_norms": plain["grad_norms"],
                "bit_equal": mesh["losses"] == plain["losses"]
                and mesh["grad_norms"] == plain["grad_norms"],
                "step_ms": mesh["step_ms"],
                "unsharded_step_ms": plain["step_ms"],
                "peak_gib": mesh["peak_gib"],
                "unsharded_peak_gib": plain["peak_gib"],
                "flash_fwd_per_step": fwd, "flash_bwd_per_step": bwd,
                "launches_per_step": mesh["launches"]}
        emit(line)
        attends = get_config(arch).num_heads > 0
        if not (all(math.isfinite(x) for x in mesh["losses"])
                and line["bit_equal"] and not any(mesh["skipped"])
                and all(bool(f) == attends and bool(b) == attends
                        for f, b in zip(fwd, bwd))):
            raise AssertionError(f"train_mesh: {arch}'s mesh run: {line}")


def train_mesh_phase(dev, train_line: dict) -> dict:
    """Phase 8c': the sharded training step at world 1. Returns the flash
    launches of its gemma3-1b run (every step's)."""
    gemma = timed_part("train_mesh", "gemma3-1b", train_mesh_gemma, dev,
                       train_line)
    timed_part("train_mesh", "gemma3-1b dots", train_mesh_dots, dev,
               train_line)
    timed_part("train_mesh", "mixtral-8x7b", train_mesh_mixtral, dev)
    timed_part("train_mesh", "families", train_mesh_families, dev)
    total = {}
    for counts in gemma["launches_per_step"]:
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    return total


# ---------------------------------------------------------------------------
# Phase 8d: the trace-discipline suite on the card
# ---------------------------------------------------------------------------
def analysis_audit(dev) -> dict:
    """(a) The op audit with device "cuda": every chunk program run once
    uncaptured under the op recorder; raises on a failed invariant."""
    import io
    from repro_torch.analysis.op_audit import (TINY, check_report,
                                               collect_report)
    report = collect_report(dev)
    out = io.StringIO()
    ok = check_report(report, out)
    line = {"phase": "analysis", "part": "op audit",
            "device": report["device"], "torch": report["torch_version"],
            "rounds_per_program": TINY["K"],
            "programs": {name: {"ops": s["total"], "syncs": s["syncs"],
                                "f64": s["f64"], "launches": s["launches"],
                                "out_dtypes": s["out_dtypes"]}
                         for name, s in report["programs"].items()},
            "install": report["invariants"], "ok": ok}
    emit(line)
    if not ok:
        raise AssertionError(f"analysis: the op audit failed on the card:\n"
                             f"{out.getvalue()}")
    return line


def analysis_main_cost(main_run, dev) -> dict:
    """(b) The cost model over one uncaptured chunk of phase main's
    search (its build, queries and parameters, a fresh state): per
    round, its operations and bytes, by kernel and by op, and the HBM
    share that phase main's time per device round (its search_s over
    the rounds the device ran) implies."""
    import torch
    from repro_torch.core import engine as E
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.launch.opanalysis import analyze
    consts, geom, entry = main_run["engine"]
    params = E.EngineParams.lossless(SearchParams(L=L, W=W, k=K),
                                     NQ // SHARDS, DEGREE, coalesce_qb=QB)
    qsh = torch.as_tensor(
        main_run["queries"].reshape(SHARDS, NQ // SHARDS, -1), device=dev)
    st = E._init_state(qsh, E._qq(qsh), *entry, params)
    t = torch.zeros((), dtype=torch.int32, device=dev)
    rounds = E.SEARCH_CHUNK
    rep = analyze(E._search_chunk, consts, st, t, qsh, params, geom, rounds,
                  E._Part(SHARDS))
    res = main_run["res"]
    per_round = {"flops": rep["flops"] / rounds,
                 "bytes": rep["hbm_bytes"] / rounds}
    # phase main's captured search: search_s over the rounds the device
    # ran (dead rounds included, as the cost model counts them)
    rate = per_round["bytes"] * res["device_rounds"] / res["search_s"]
    top = sorted(rep["by_op"].items(), key=lambda kv: -kv[1]["bytes"])[:8]
    line = {"phase": "analysis", "part": "cost model, main search chunk",
            "rounds": rounds, "flops_per_round": per_round["flops"],
            "bytes_per_round": per_round["bytes"],
            "aten_ops_per_round": sum(
                e["count"] for n, e in rep["by_op"].items()
                if not n.startswith("kernel::")) / rounds,
            "kernels_per_round": {
                k: {"launches": e["launches"] / rounds,
                    "flops": e["flops"] / rounds,
                    "bytes": e["bytes"] / rounds}
                for k, e in rep["kernels"].items()},
            "top_ops_by_bytes_per_round": {
                n: e["bytes"] / rounds for n, e in top},
            "main_host_ms_per_round": res["host_ms_per_round"],
            "main_ms_per_device_round":
                1e3 * res["search_s"] / res["device_rounds"],
            "main_search_s": res["search_s"],
            "main_device_rounds": res["device_rounds"],
            "implied_bytes_per_s": rate,
            "implied_share_of_3.35TB/s": rate / HBM_BYTES_PER_S,
            "warnings": rep["warnings"]}
    emit(line)
    want = {k: rounds for k in SEARCH_KERNELS}
    got = {k: e["launches"] for k, e in rep["kernels"].items()}
    if got != want:
        raise AssertionError(f"analysis: the main chunk launched {got}, "
                             f"expected {want}")
    return line


def analysis_train_flops(dev, remat: str = "full") -> dict:
    """(c) One gemma3-1b train step at phase train's shape (fresh
    parameters from the seed, step 0's batch) counted by the cost model,
    beside model_flops: the counted step also runs remat's second
    forward (and the optimizer's elementwise updates); under ``remat``
    "dots" (phase plan's dots cell) the second forward less the kept
    products."""
    import torch
    from repro_torch.launch.opanalysis import analyze
    from repro_torch.launch.train import build
    from repro_torch.train.trainer import init_train_state
    cfg, oc, step_fn, pipe, _ = build(train_args(remat=remat))
    params, opt = init_train_state(
        cfg, oc, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}
    rep = analyze(step_fn, params, opt, batch)
    nparams = sum(p.numel() for p in params.parameters())
    mf = model_flops(cfg, nparams, TRAIN["batch"], TRAIN["seq"])
    mm = sum(e["flops"] for n, e in rep["by_op"].items()
             if n.split(".")[0] in ("aten::mm", "aten::addmm", "aten::bmm",
                                    "aten::baddbmm"))
    line = {"phase": "analysis", "part": "cost model, train step",
            "remat": remat,
            "arch": cfg.name, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "params": nparams, "counted_flops": rep["flops"],
            "model_flops": mf, "counted_over_model": rep["flops"] / mf,
            "matmul_flops": mm, "kernels": rep["kernels"],
            "other_flops": rep["flops"] - mm - sum(
                e["flops"] for e in rep["kernels"].values()),
            "hbm_bytes": rep["hbm_bytes"],
            "aten_ops": sum(e["count"] for n, e in rep["by_op"].items()
                            if not n.startswith("kernel::"))}
    emit(line)
    del rep, params, opt
    gc.collect()
    torch.cuda.empty_cache()
    if not math.isfinite(line["counted_flops"]) or \
            line["counted_over_model"] < 1.0:
        raise AssertionError(f"analysis: the counted step is below the "
                             f"model's operations: {line}")
    return line


def analysis_phase(dev, main_run) -> None:
    """Phase 8d: (a)-(c), each a timed part. (The CaptureGuard check of
    a ring-wrapping half-resident session runs in phase tiered.)"""
    timed_part("analysis", "op audit", analysis_audit, dev)
    timed_part("analysis", "main chunk cost", analysis_main_cost, main_run,
               dev)
    return timed_part("analysis", "train step cost", analysis_train_flops,
                      dev)


# ---------------------------------------------------------------------------
# Phase 8e: the planning half (launch/specs.py, launch/dryrun.py)
# ---------------------------------------------------------------------------
def start_plan_cells():
    """Start phase plan's dry-run cells (meta tensors; nothing on the
    card) in a spawn pool of PLAN_WORKERS processes, from phase 2 on:
    the engine on both production meshes, one train_4k cell per family
    on the 16 x 16 mesh, and the five full-attention archs' long_500k
    skips. Returns (pool, their async results); the caller terminates
    the pool."""
    import multiprocessing
    from repro_torch.launch.dryrun import run_cell, run_engine_cell
    jobs = [(run_cell, (arch, "train_4k", "single"), {})
            for arch in PLAN_CELLS]
    jobs += [(run_engine_cell, (), {"mesh_kind": m})
             for m in ("single", "multi")]
    jobs += [(run_cell, (arch, "long_500k", "single"), {})
             for arch in PLAN_SKIPS]
    pool = multiprocessing.get_context("spawn").Pool(PLAN_WORKERS)
    return pool, [pool.apply_async(fn, a, kw) for fn, a, kw in jobs]


def plan_cells(pending) -> list:
    """(a) The dry-run cells' records (:func:`start_plan_cells`): every
    record is ok, or a skip with the reference's reason; none is an
    error."""
    recs = [p.get(timeout=600) for p in pending]
    for r in recs:
        line = {"phase": "plan", "part": "dry run", "arch": r["arch"],
                "shape": r["shape"], "mesh": r["mesh"],
                "status": r["status"], "trace_s": r.get("trace_s")}
        if r["status"] == "ok":
            mem, pd = r["memory"], r["per_device"]
            line.update(flops=pd["flops"], hbm_bytes=pd["hbm_bytes"],
                        collective_bytes=pd["collective_bytes"],
                        collectives=pd["collectives"]["bytes_by_kind"],
                        peak_bytes=mem["peak_bytes_per_device"],
                        fits_hbm=mem["fits_hbm"], roofline=r["roofline"],
                        link_note=r["link_note"])
        else:
            line.update(reason=r.get("reason"), error=r.get("error"))
        emit(line)
        want = "skip" if r["shape"] == "long_500k" else "ok"
        reason = (f"{r['arch']} is pure full-attention: long_500k skipped "
                  f"per assignment (DESIGN.md §6)")
        if r["status"] != want or (want == "skip"
                                   and r["reason"] != reason):
            raise AssertionError(f"plan: {r['arch']} {r['shape']} "
                                 f"{r['mesh']}: {r['status']} "
                                 f"{r.get('reason') or r.get('error')}")
    return recs


def plan_train_cell(dev, counted: dict, measured_ms: float,
                    remat: str = "full") -> dict:
    """(b) Phase train's own cell planned at mesh data 1 x model 1
    (gemma3-1b, f32, batch 4 x 1024, ``remat``, loss chunk 512) beside
    this run's readings: the predicted operations against the cost
    model's count of the same step (phase analysis, or for dots its own;
    within 1%), the argument bytes of the parameters and optimizer state
    against the live train state's bytes (equal), the predicted peak
    against torch.cuda.max_memory_allocated over one step, and the
    roofline bound against phase train's ms per step
    (``measured_ms``)."""
    import torch
    from repro_torch.launch.dryrun import analyze_plan
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import ArchPolicy, plan_train
    from repro_torch.launch.train import build
    from repro_torch.models.transformer import ModelOpts
    from repro_torch.train.trainer import init_train_state
    from repro_torch.utils import tree_leaves
    cfg, oc, step_fn, pipe, _ = build(train_args(remat=remat))
    mesh = make_mesh_for(1, (1, 1), ("data", "model"))
    plan = plan_train(cfg, mesh, batch=TRAIN["batch"], seq=TRAIN["seq"],
                      policy=ArchPolicy(loss_chunk=TRAIN["loss_chunk"],
                                        param_dtype=torch.float32),
                      opts=ModelOpts(remat=remat,
                                     loss_chunk=TRAIN["loss_chunk"]))
    t0 = time.perf_counter()
    rec = analyze_plan(plan)
    plan_s = time.perf_counter() - t0
    params, opt = init_train_state(
        cfg, oc, torch.Generator(device=dev).manual_seed(0))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))
    state = nbytes(list(params.parameters())) + nbytes(
        [opt["m"], opt["v"], opt["step"]])
    inputs = nbytes(list(batch.values()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step_fn(params, opt, batch)
    torch.cuda.synchronize()
    step_peak = torch.cuda.max_memory_allocated() - before
    mem, pd = rec["memory"], rec["per_device"]
    parts = mem["argument_parts"]
    measured_peak = state + inputs + step_peak
    bound_ms = rec["roofline"]["step_s_lower_bound"] * 1e3
    line = {"phase": "plan", "part": "train cell, data 1 x model 1",
            "remat": remat,
            "arch": cfg.name, "batch": TRAIN["batch"], "seq": TRAIN["seq"],
            "plan_s": plan_s,
            "predicted_flops": pd["flops"],
            "cost_model_flops": counted["counted_flops"],
            "flops_ratio": pd["flops"] / counted["counted_flops"],
            "predicted_hbm_bytes": pd["hbm_bytes"],
            "cost_model_hbm_bytes": counted["hbm_bytes"],
            "predicted_state_bytes": parts["params"] + parts["opt"],
            "live_state_bytes": state,
            "predicted_input_bytes": parts["inputs"],
            "live_input_bytes": inputs,
            "predicted_peak_bytes": mem["peak_bytes_per_device"],
            "predicted_temp_bytes": mem["temp_bytes"],
            "measured_peak_bytes": measured_peak,
            "measured_step_peak_bytes": step_peak,
            "peak_ratio_predicted_over_measured":
                mem["peak_bytes_per_device"] / measured_peak,
            "roofline": rec["roofline"],
            "bound_ms": bound_ms,
            "measured_ms_per_step": measured_ms,
            "bound_over_measured": bound_ms / measured_ms,
            "collective_bytes": pd["collective_bytes"]}
    emit(line)
    del params, opt, batch
    gc.collect()
    torch.cuda.empty_cache()
    if abs(line["flops_ratio"] - 1.0) > PLAN_FLOPS_RTOL:
        raise AssertionError(f"plan: predicted operations differ from the "
                             f"cost model's by more than "
                             f"{PLAN_FLOPS_RTOL}: {line}")
    if line["predicted_state_bytes"] != state:
        raise AssertionError(f"plan: planned state bytes "
                             f"{line['predicted_state_bytes']} != the live "
                             f"state's {state}")
    if not (math.isfinite(line["peak_ratio_predicted_over_measured"])
            and line["collective_bytes"] == 0):
        raise AssertionError(f"plan: {line}")
    return line


def plan_factored_step(dev) -> dict:
    """(c) One AdamW step with the factored second moment at phase
    train's cell (gemma3-1b, full width, f32): the loss is finite, every
    moment finite, and state_tree's v has the reference's structure: r
    and c of the stacked view for every leaf of two or more dims there
    (a per-layer norm scale: r (L,), c (d,)), f for the rest."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.transformer import ModelOpts
    from repro_torch.optim import OptConfig
    from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                           make_train_step, state_like)
    from repro_torch.utils import tree_leaves
    cfg = get_config(TRAIN["arch"])
    oc = OptConfig(lr_max=TRAIN["lr"], warmup=TRAIN["warmup"],
                   factored_v=True)
    params, opt = init_train_state(
        cfg, oc, torch.Generator(device=dev).manual_seed(0))
    step = make_train_step(cfg, oc, TrainConfig(),
                           opts=ModelOpts(loss_chunk=TRAIN["loss_chunk"]))
    pipe = TokenPipeline(cfg.vocab_size, TRAIN["batch"], TRAIN["seq"], 0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.batch_at(0).items()}
    params, opt, m = step(params, opt, batch)
    loss = float(m["loss"])
    finite = bool(all(torch.isfinite(t).all()
                      for t in tree_leaves(opt["v"]) + tree_leaves(opt["m"])))
    like = state_like(params, opt)
    bad, kinds = [], {"rc": 0, "f": 0}

    def check(p, v, path=""):
        if isinstance(p, dict):
            for k in p:
                check(p[k], v[k], f"{path}/{k}")
            return
        shape = tuple(p.shape)
        if len(shape) >= 2:
            want = {"r": shape[:-1], "c": shape[:-2] + shape[-1:]}
            kinds["rc"] += 1
        else:
            want = {"f": shape}
            kinds["f"] += 1
        got = {k: tuple(t.shape) for k, t in v.items()}
        if got != want:
            bad.append((path, got, want))
    check(like["params"], like["opt"]["v"])
    line = {"phase": "plan", "part": "factored AdamW step", "arch": cfg.name,
            "loss": loss, "moments_finite": finite, "v_leaves": kinds,
            "v_blocks_ln1_scale": {k: list(t.shape) for k, t in
                                   like["opt"]["v"]["blocks"]["ln1"]
                                   ["scale"].items()},
            "mismatches": bad[:4]}
    emit(line)
    del params, opt, batch, like
    gc.collect()
    torch.cuda.empty_cache()
    if not (math.isfinite(loss) and finite and not bad):
        raise AssertionError(f"plan: factored step {line}")
    return line


def plan_phase(dev, counted: dict, run_line: dict, pending) -> None:
    """Phase 8e: (a)-(d), each a timed part, then the phase's seconds."""
    t0 = time.perf_counter()
    timed_part("plan", "dry run cells", plan_cells, pending)
    timed_part("plan", "train cell", plan_train_cell, dev, counted,
               run_line["ms_per_step_median_3_10"])
    timed_part("plan", "factored step", plan_factored_step, dev)
    # (d) the same cell under remat dots, beside its own count on the card
    counted = timed_part("plan", "dots step cost", analysis_train_flops,
                         dev, "dots")
    timed_part("plan", "train cell dots", plan_train_cell, dev, counted,
               run_line["dots"]["ms_per_step_median_3_6"], "dots")
    emit({"phase": "plan", "seconds": round(time.perf_counter() - t0, 2)})


# ---------------------------------------------------------------------------
# Phase 9: timing at each path's shapes
# ---------------------------------------------------------------------------
def routed_bitonic_rows(dev) -> list:
    """Timing rows of the standalone sort and merge at the routed path's
    shapes, no payload lane: the route's sort of every query's shard
    scores (B 2048, M 8) and the fusion merge row A(10) ++ filler(12) ++
    reversed(B(10)) (B 2048, M 32). Each also carries its operands at one
    row of two entries (the one-launch floor)."""
    import torch
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref)
    from repro_torch.kernels.topk.kernel import bitonic_cost
    from repro_torch.utils import BIG_DIST, ID_SENTINEL
    rows = []
    tiny = sort_rows(1, 2, dev, seed=2)[:2]
    B, M = ROUTE_SORT
    g = torch.Generator(device=dev).manual_seed(11)
    sd = torch.rand((B, M), generator=g, device=dev) * 1e4
    si = torch.arange(M, dtype=torch.int32, device=dev).expand(B, M)
    si = si.contiguous()
    ops, nbytes = bitonic_cost(B, M, 0, merge_only=False)
    b, by = bound_ms(nbytes, ops)
    rows.append(("bitonic_sort", (sd, si), bitonic_sort, bitonic_sort_ref,
                 lambda: torch.sort(sd, dim=-1, stable=True), b, by,
                 dict(B=B, M=M, payload_lanes=0,
                      row="route: one query's 8 shard scores",
                      floor_args=tiny)))
    B, M = FUSE_MERGE
    k = K
    ad, ai = bitonic_sort_ref(*sort_rows(B, k, dev, seed=k)[:2])
    bd, bi = bitonic_sort_ref(*sort_rows(B, k, dev, seed=k + 1)[:2])
    fill = M - 2 * k
    md = torch.cat([ad, ad.new_full((B, fill), BIG_DIST), bd.flip(1)], 1)
    mi = torch.cat([ai, ai.new_full((B, fill), ID_SENTINEL), bi.flip(1)], 1)
    cat_d = torch.cat([ad, bd], 1)
    ops, nbytes = bitonic_cost(B, M, 0, merge_only=True)
    b, by = bound_ms(nbytes, ops)
    rows.append(("bitonic_merge", (md, mi), bitonic_merge,
                 bitonic_merge_ref,
                 lambda: torch.sort(cat_d, dim=-1, stable=True), b, by,
                 dict(B=B, M=M, payload_lanes=0,
                      row="fusion: A(10) ++ filler(12) ++ reversed(B(10))",
                      floor_args=tiny)))
    return rows


def distance_floor(P, d, dev, qt=None, dt=None):
    """The distance kernel's one-launch floor: its operands at one tile of
    one query row (T 1, QB 1) against a page of the row's P and d, in the
    row's types."""
    import torch
    args = distance_case(1, 1, P, d, 2, dev, False, seed=1)
    return as_dtypes(args, qt or torch.float32, dt or torch.float32)


def router_distance_row(dev):
    """The timing row of the distance kernel at the router's shape: one
    tile per shard, the stream's 2048 sift-1b queries (S contiguous
    copies, as ShardRouter.shard_scores passes them) against the shard's
    8 centroids (rows of the stand-in)."""
    import numpy as np
    import torch
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    from repro_torch.kernels.distance.kernel import cost as distance_cost
    from repro_torch.launch.search import dataset
    T, qb, P, d, NP, _ = ROUTER_TILES
    ds = dataset("sift-1b")
    q = torch.as_tensor(ds.queries(qb, seed=1), device=dev)
    rows = np.random.default_rng(0).choice(ds.n, NP * P, replace=False)
    cent = torch.as_tensor(ds.materialize()[rows], device=dev)
    cent = cent.reshape(NP, P, d).contiguous()
    cnorm = (cent * cent).sum(-1)
    qt = q[None].expand(T, -1, -1).contiguous()
    qqt = (qt * qt).sum(-1)
    pid = torch.arange(T, dtype=torch.int32, device=dev)
    base = qqt[:, :, None] + cnorm[:, None, :]
    ops, nbytes = distance_cost(T, qb, P, d, NP, pages=NP)
    b, by = bound_ms(nbytes, ops)
    return ("paged_distance", (pid, qt, qqt, cent, cnorm), paged_distances,
            paged_distances_ref,
            lambda: torch.baddbmm(base, qt, cent.transpose(1, 2),
                                  alpha=-2.0),
            b, by, dict(T=T, QB=qb, P=P, d=d, NP=NP,
                        floor_args=distance_floor(P, d, dev)))


def tiered_distance_row(dev):
    """The timing row of the distance kernel at the tiered sessions'
    shape (tiered_tiles): the sift-1b stand-in's first vectors as the
    frame buffer, page-sorted tiles, real vectors as queries; the library
    call is baddbmm on pre-gathered pages."""
    import torch
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    from repro_torch.kernels.distance.kernel import cost as distance_cost
    from repro_torch.launch.search import dataset
    T, qb, P, d, npages = tiered_tiles()
    g = torch.Generator(device=dev).manual_seed(13)
    db0 = torch.as_tensor(dataset("sift-1b").materialize()[:npages * P],
                          device=dev)
    frames = db0.reshape(npages, P, d).contiguous()
    vnorm = (frames * frames).sum(-1)
    pid = torch.sort(torch.randint(0, npages, (T,), generator=g,
                                   device=dev, dtype=torch.int32)).values
    q = frames[torch.randint(0, npages, (T,), generator=g, device=dev),
               :qb].contiguous()
    qq = (q * q).sum(-1)
    pages = frames[pid.long()]
    base = qq[:, :, None] + vnorm[pid.long()][:, None, :]
    uniq = int(torch.unique(pid).numel())
    ops, nbytes = distance_cost(T, qb, P, d, npages, pages=uniq)
    b, by = bound_ms(nbytes, ops)
    return ("paged_distance", (pid, q, qq, frames, vnorm), paged_distances,
            paged_distances_ref,
            lambda: torch.baddbmm(base, q, pages.transpose(1, 2),
                                  alpha=-2.0),
            b, by, dict(T=T, QB=qb, P=P, d=d, NP=npages,
                        floor_args=distance_floor(P, d, dev)))


def bitonic_rows(dev) -> list:
    """Timing rows of the search path's bitonic shapes: the proposals'
    sort (B 256, M 16) and the merge row A(32) ++ filler(16) ++
    reversed(B(16)) (M 64), which no path launches (the fused Gather
    merge does their work), and the fused Gather merge (R 256, LA 32, LB 16,
    out_w 32). Each also carries its operands at one row of two entries
    (the one-launch floor)."""
    import torch
    from repro_torch.kernels.topk import (bitonic_merge, bitonic_merge_ref,
                                          bitonic_sort, bitonic_sort_ref)
    from repro_torch.kernels.topk.kernel import bitonic_cost
    from repro_torch.utils import BIG_DIST, ID_SENTINEL
    R, la, lb = GATHER["R"], GATHER["LA"], GATHER["LB"]
    M = 64
    rows = []
    dd, ii, pp = sort_rows(R, lb, dev, seed=lb)
    tiny = sort_rows(1, 2, dev, seed=2)
    ops, nbytes = bitonic_cost(R, lb, 1, merge_only=False)
    b, by = bound_ms(nbytes, ops)
    rows.append(("bitonic_sort", (dd, ii, pp), bitonic_sort, bitonic_sort_ref,
                 lambda dd=dd: torch.sort(dd, dim=-1, stable=True), b, by,
                 dict(B=R, M=lb, payload_lanes=1, floor_args=tiny)))
    ad, ai, ap = bitonic_sort_ref(*sort_rows(R, la, dev, seed=la))
    bd, bi, _ = bitonic_sort_ref(*sort_rows(R, lb, dev, seed=lb + 1))
    fill = M - la - lb
    md = torch.cat([ad, ad.new_full((R, fill), BIG_DIST), bd.flip(1)], 1)
    mi = torch.cat([ai, ai.new_full((R, fill), ID_SENTINEL), bi.flip(1)], 1)
    mp = torch.cat([ap, ap.new_zeros((R, fill + lb))], 1)
    ops, nbytes = bitonic_cost(R, M, 1, merge_only=True)
    b, by = bound_ms(nbytes, ops)
    rows.append(("bitonic_merge", (md, mi, mp), bitonic_merge,
                 bitonic_merge_ref,
                 lambda md=md: torch.sort(md, dim=-1, stable=True), b, by,
                 dict(B=R, M=M, payload_lanes=1,
                      row="A(32) ++ filler(16) ++ reversed(B(16))",
                      floor_args=tiny)))
    floor = tuple(x[:1] for x in gather_case(2, 1, 1, dev, seed=1)) + (2,)
    rows.append(gather_row(R, la, lb, dev, floor_args=floor))
    return rows


def lanes_row(dev):
    """The timing row of the sort with 3 payload lanes (i32, f32, i32) at
    B 2048, M 32 (positions through the network, an epilogue permuting
    every lane); its bound moves dist, id and every lane once each way;
    the library call is torch.sort of the keys and a gather of each lane
    by its indices."""
    import torch
    from repro_torch.kernels.topk import bitonic_sort, bitonic_sort_ref
    from repro_torch.kernels.topk.kernel import bitonic_cost
    B, M = LANE_SORTS[0]
    d, i, _ = sort_rows(B, M, dev, seed=M + 2)
    lanes = lane_words(B, M, dev, seed=M + 3,
                       dtypes=(torch.int32, torch.float32, torch.int32))
    ops, nbytes = bitonic_cost(B, M, len(lanes), False)
    b, by = bound_ms(nbytes, ops)

    def lib():
        idx = torch.sort(d, dim=-1, stable=True).indices
        return [x.gather(-1, idx) for x in (d, i, *lanes)]
    return ("bitonic_sort", (d, i, *lanes), bitonic_sort, bitonic_sort_ref,
            lib, b, by, dict(B=B, M=M, payload_lanes=3,
                             lanes="i32, f32, i32"))


def gather_row(R, la, lb, dev, **shape):
    """The timing row of the fused Gather merge (merge_unsorted) at R
    rows of LA candidates and LB proposals, out_w = LA: its bound counts
    the proposals' sort network over next_pow2(LB) and the merge stages
    over next_pow2(LA + next_pow2(LB))."""
    import torch
    from repro_torch.kernels.topk import merge_unsorted, merge_unsorted_ref
    from repro_torch.kernels.topk.kernel import merge_unsorted_cost
    case = gather_case(R, la, lb, dev, seed=5)
    cat_d = torch.cat([case[0], case[3]], 1)
    out_w = la
    cmps, nbytes = merge_unsorted_cost(R, la, lb, out_w)
    b, by = bound_ms(nbytes, cmps)
    return ("bitonic_merge_unsorted", case + (out_w,), merge_unsorted,
            merge_unsorted_ref,
            lambda: torch.sort(cat_d, dim=-1, stable=True), b, by,
            dict(R=R, LA=la, LB=lb, out_w=out_w, **shape))


def flash_row(shape: dict, kw: dict, dev):
    """A timing row of flash attention at ``shape`` (S = Skv, f32): the
    kernel (``kv_valid`` as its ``s_orig``, as attention_op passes it),
    its plain version, and the library call, SDPA on repeated kv with an
    explicit boolean mask (none when non-causal); the bound counts 4 dh
    operations per unmasked (row, col) pair."""
    import torch
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.flash_attention.kernel import cost as flash_cost
    fq, fk, fv = qkv(**shape, dtype=torch.float32, dev=dev, seed=5)
    group = shape["H"] // shape["Hkv"]
    fkr, fvr = (x.repeat_interleave(group, dim=1) for x in (fk, fv))
    S, causal = shape["S"], kw.get("causal", True)
    window = kw.get("window", 0)
    kw = dict(scale=shape["dh"] ** -0.5, causal=causal, window=window,
              s_orig=kw.get("kv_valid", 0))
    ar = torch.arange(S, device=dev)
    mask = None
    if causal:
        mask = ar[None, :] <= ar[:, None]
        if window:
            mask = mask & (ar[:, None] - ar[None, :] < window)
    pairs = attn_pairs(S, causal, window) * shape["B"] * shape["H"]
    ops, nbytes = flash_cost(fq.shape, fk.numel(), 4, S, causal=causal,
                             window=window)
    b, by = bound_ms(nbytes, ops)
    return ("flash_attention", (fq, fk, fv),
            lambda *a: flash_attention(*a, **kw),
            lambda *a: attention_ref(*a, **kw),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                fq, fkr, fvr, attn_mask=mask, scale=kw["scale"]),
            b, by, dict(shape, causal=causal, window=window,
                        unmasked_pairs=pairs))


def flash_bwd_row(shape: dict, kw: dict, dev, earlier_ms=None):
    """A timing row of the flash backward at ``shape`` (f32) from the
    forward's out and lse: the kernels (both, per call), their plain
    version, and the library call, torch.autograd's backward of SDPA on
    repeated kv (explicit boolean mask where causal; the forward taken
    once, outside the timing, its graph kept). ``kw``: window, causal
    and kv_valid (``s_orig``) as flash_row takes them. The bound counts
    the backward's five products (s, dP, dq, dk, dv), 2 dh operations
    each, per unmasked (row, col) pair and head; its bytes read q, k, v,
    out, dout and lse once and write dq, dk, dv once. ``earlier_ms``:
    the first design's time at this shape (three kernels, s and dP
    computed twice, on an H100 80GB HBM3 at 700 W), printed beside the
    row where there is one."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import cost as flash_cost
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    fq, fk, fv = qkv(**shape, dtype=torch.float32, dev=dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    fdo = torch.randn(fq.shape, generator=g, device=dev)
    S, window = shape["S"], kw.get("window", 0)
    causal = kw.get("causal", True)
    kw = dict(scale=shape["dh"] ** -0.5, causal=causal, window=window,
              s_orig=kw.get("kv_valid", 0))
    out, lse = flash_attention(fq, fk, fv, return_lse=True, **kw)
    group = shape["H"] // shape["Hkv"]
    lq, lk, lv = (x.clone().requires_grad_() for x in (fq, fk, fv))
    lkr, lvr = (x.repeat_interleave(group, dim=1) for x in (lk, lv))
    ar = torch.arange(S, device=dev)
    mask = None
    if causal:
        mask = ar[None, :] <= ar[:, None]
        if window:
            mask = mask & (ar[:, None] - ar[None, :] < window)
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        lq, lkr, lvr, attn_mask=mask, scale=kw["scale"])
    pairs = attn_pairs(S, causal, window) * shape["B"] * shape["H"]
    ops, nbytes = flash_cost(fq.shape, fk.numel(), 4, S, causal=causal,
                             window=window, backward=True)
    b, by = bound_ms(nbytes, ops)
    info = dict(shape, causal=causal, window=window, unmasked_pairs=pairs)
    if earlier_ms is not None:
        info["earlier_ms"] = earlier_ms
    return ("flash_attention_bwd", (fq, fk, fv, out, lse, fdo),
            lambda *a: flash_attention_bwd(*a, **kw),
            lambda *a: attention_bwd_ref(*a, **kw),
            lambda: torch.autograd.grad(sdpa, (lq, lk, lv), fdo,
                                        retain_graph=True),
            b, by, info)


def flash_lse_row(shape: dict, kw: dict, dev):
    """flash_row's timing of the forward with its lse (the training
    path's launch): the plain version attention_fwd_ref, the library
    call SDPA's forward as in flash_row; the bound adds the lse's
    bytes."""
    import torch
    from repro_torch.kernels.flash_attention.kernel import cost as flash_cost
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_fwd_ref
    name, args, _, _, lib, _, _, info = flash_row(shape, kw, dev)
    fq = args[0]
    kw = dict(scale=shape["dh"] ** -0.5, causal=True,
              window=kw.get("window", 0))
    ops, nbytes = flash_cost(fq.shape, args[1].numel(), 4, shape["S"],
                             causal=True, window=kw["window"], lse=True)
    b, by = bound_ms(nbytes, ops)
    return (name, args, lambda *a: flash_attention(*a, return_lse=True, **kw),
            lambda *a: attention_fwd_ref(*a, **kw), lib, b, by, info)


def search_distance_rows(dev) -> list:
    """The distance kernel's timing rows at the main path's tiles (sorted
    page ids over the sift-1b stand-in's vectors, real vectors as
    queries): the f32 kernel, then its bf16 instantiations on the same
    tiles, each (name, args, kernel, plain, library call, bound ms,
    bound_by, shape)."""
    import torch
    from repro_torch.kernels.distance import (paged_distances,
                                              paged_distances_ref)
    from repro_torch.kernels.distance.kernel import cost as distance_cost
    from repro_torch.launch.search import dataset

    T, qb, P, d, npages = main_path_tiles()
    g = torch.Generator(device=dev).manual_seed(7)
    # the sift-1b stand-in's vectors, paged in id order (zero-padded)
    db0 = torch.as_tensor(dataset("sift-1b").materialize(), device=dev)
    store = db0.new_zeros((npages * P, d))
    store[:min(len(db0), npages * P)] = db0[:npages * P]
    store = store.reshape(npages, P, d)
    vnorm = (store * store).sum(-1)
    pid = torch.sort(torch.randint(0, npages, (T,), generator=g,
                                   device=dev, dtype=torch.int32)).values
    q = store[torch.randint(0, npages, (T,), generator=g, device=dev),
              :qb].contiguous()                       # real vectors as queries
    qq = (q * q).sum(-1)
    dargs = (pid, q, qq, store, vnorm)
    pages = store[pid.long()]
    base = qq[:, :, None] + vnorm[pid.long()][:, None, :]
    uniq = int(torch.unique(pid).numel())
    rows = []
    ops, nbytes = distance_cost(T, qb, P, d, npages, pages=uniq)
    b, by = bound_ms(nbytes, ops)
    rows.append(("paged_distance", dargs, paged_distances,
                 paged_distances_ref,
                 lambda: torch.baddbmm(base, q, pages.transpose(1, 2),
                                       alpha=-2.0),
                 b, by, dict(T=T, QB=qb, P=P, d=d, NP=npages,
                             floor_args=distance_floor(P, d, dev))))
    # the bf16 instantiations on the same tiles: bf16 operands move half
    # the bytes; the library call is baddbmm on the upcast, pre-gathered
    # operands
    for name, (qt, dt) in bf16_distance().items():
        args = as_dtypes(dargs, qt, dt)
        qf, pf = args[1].float(), args[3][pid.long()].float()
        base_b = args[2][:, :, None] + args[4][pid.long()][:, None, :]
        # bf16 operands move their halved bytes; bf16 x bf16 products at
        # the tensor cores' bf16 rate; a product with an f32 operand, and
        # the qq / vnorm adds, at the f32 rate
        nbytes_b = distance_cost(T, qb, P, d, npages, pages=uniq,
                                 q_itemsize=qt.itemsize,
                                 db_itemsize=dt.itemsize)[1]
        dot = 2.0 * T * qb * P * d
        both = qt == dt == torch.bfloat16
        b, by = bound_ms(nbytes_b, ops - dot if both else ops,
                         bf16_ops=dot if both else 0.0)
        rows.append((name, args, paged_distances, paged_distances_ref,
                     lambda qf=qf, pf=pf, base_b=base_b: torch.baddbmm(
                         base_b, qf, pf.transpose(1, 2), alpha=-2.0),
                     b, by, dict(T=T, QB=qb, P=P, d=d, NP=npages,
                                 queries=dtype_name(qt),
                                 store=dtype_name(dt),
                                 floor_args=distance_floor(P, d, dev, qt,
                                                           dt))))
    return rows


def time_kernels(dev) -> list:
    """Time every kernel row; returns [(kernel entry without its launch
    count and error, the timing line's other fields)]."""
    from repro_torch.kernels import KERNELS

    rows = search_distance_rows(dev)
    search_bitonic = bitonic_rows(dev)
    rows += routed_bitonic_rows(dev) + search_bitonic[2:]
    # flash attention at gemma3-1b's prefill shape (a local layer, and on a
    # line of its own a global one); its backward at the training shape
    # (the same attention shape)
    rows.append(flash_row(G3, dict(window=512), dev))
    rows.append(flash_bwd_row(G3, dict(window=512), dev, 1.472))
    # rows on a line of their own: flash at a global layer and at the
    # other families' prefill shapes, the Gather merge at spec 4's
    # proposals (the streaming phase)
    extra = [(flash_row(G3, dict(window=0), dev),
              dict(case="global layer (window 0)",
                   layers_per_prefill=GLOBAL_LAYERS)),
             (flash_bwd_row(G3, dict(window=0), dev, 2.430),
              dict(case="backward, global layer (window 0)",
                   launches_per_train_step=GLOBAL_LAYERS)),
             (flash_lse_row(G3, dict(window=512), dev),
              dict(case="forward with lse (training path), local layer",
                   launches_per_train_step=2 * 22)),
             (flash_lse_row(G3, dict(window=0), dev),
              dict(case="forward with lse (training path), global layer",
                   launches_per_train_step=2 * GLOBAL_LAYERS)),
             (flash_row(MIXTRAL_ATTN, dict(window=4096), dev),
              dict(case="mixtral-8x7b prefill (GQA 32/8, window 4096)",
                   layers_per_prefill=8)),
             (flash_row(ZAMBA2_ATTN, dict(window=4096), dev),
              dict(case="zamba2-1.2b shared block (window 4096)",
                   layers_per_prefill=6)),
             (flash_row(SEAMLESS_ATTN, dict(causal=False), dev),
              dict(case="seamless-m4t-medium encoder (non-causal)",
                   layers_per_prefill=12)),
             (flash_row(SEAMLESS_ATTN, dict(window=0), dev),
              dict(case="seamless-m4t-medium decoder self-attention",
                   layers_per_prefill=12)),
             (flash_row(SEAMLESS_ATTN, dict(causal=False, kv_valid=1024),
                        dev),
              dict(case="seamless-m4t-medium cross-attention "
                        "(kv_valid = Se = 1024)",
                   layers_per_prefill=12)),
             (gather_row(GATHER["R"], GATHER["LA"], GATHER["LB_SPEC"], dev),
              dict(case="spec 4 proposals (W * (R + spec) = 20)")),
             # the backward at the dh-64 training shapes (phase
             # train_mesh's part families: B 2)
             (flash_bwd_row(dict(ZAMBA2_ATTN, B=2), dict(window=4096), dev),
              dict(case="backward, zamba2-1.2b shared block (B 2, window "
                        "4096)", launches_per_train_step=1)),
             (flash_bwd_row(dict(SEAMLESS_ATTN, B=2), dict(causal=False),
                            dev),
              dict(case="backward, seamless-m4t-medium encoder (B 2, "
                        "non-causal)", launches_per_train_step=2)),
             (flash_bwd_row(dict(SEAMLESS_ATTN, B=2), dict(window=0), dev),
              dict(case="backward, seamless-m4t-medium decoder "
                        "self-attention (B 2)", launches_per_train_step=2)),
             (flash_bwd_row(dict(SEAMLESS_ATTN, B=2),
                            dict(causal=False, kv_valid=1024), dev),
              dict(case="backward, seamless-m4t-medium cross-attention "
                        "(B 2, kv_valid = Se = 1024)",
                   launches_per_train_step=2)),
             (lanes_row(dev),
              dict(case="3 payload lanes (i32, f32, i32): positions "
                        "through the network, an epilogue")),
             (router_distance_row(dev), dict(case=ROUTER_CASE)),
             (tiered_distance_row(dev), dict(case=TIERED_CASE)),
             (search_bitonic[0], dict(case=OLD_BITONIC_CASE)),
             (search_bitonic[1], dict(case=OLD_BITONIC_CASE))]
    out = []
    by_name = {k.name: k for k in KERNELS}
    for (name, args, kern, plain, lib, b, by, shape), case in \
            [(row, None) for row in rows] + extra:
        ms, method = device_ms(lambda: kern(*args))
        plain_ms, _ = device_ms(lambda: plain(*args))
        library_ms, _ = device_ms(lib)
        host_ms = event_ms(lambda: kern(*args))
        k = by_name[name]
        entry = {"name": name, "route": "cuda",
                 "source": f"src/repro_torch/kernels/csrc/{k.source}",
                 "replaces": k.replaces, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b, "bound_by": by, "library_ms": library_ms}
        if "floor_args" in shape:     # the same kernel on one 2-entry row
            floor_args = shape.pop("floor_args")
            entry["floor_ms"], shape["floor_timed_by"] = device_ms(
                lambda: kern(*floor_args))
        line = {"shape": shape, "timed_by": method,
                "event_ms_per_call": host_ms}
        if "earlier_ms" in shape:     # an earlier design's time, this shape
            line["earlier_ms"] = shape.pop("earlier_ms")
        if name.startswith("bitonic"):   # the shared-memory body, same rows
            line["shared_body_ms"], _ = device_ms(
                lambda: kern(*args, shared=True))
        if case is not None:
            line.update(case)
        out.append((entry, line))
    return out


def distance_rows(dev) -> dict:
    """``--distance-rows``: the distance kernel's rows of phase 9, each
    timed in 3 traces of 200 calls (the least, ms) beside its largest
    difference from the plain version on the same inputs."""
    rows = [row[:4] for row in search_distance_rows(dev)]
    rows += [(name, *row[1:4]) for name, row in
             (("router", router_distance_row(dev)),
              ("tiered", tiered_distance_row(dev)))]
    out = {}
    for name, args, kern, plain in rows:
        err = float((kern(*args) - plain(*args)).abs().max())
        ms = [device_ms(lambda: kern(*args), iters=200)[0]
              for _ in range(3)]
        out[name] = {"ms": min(ms), "traces_ms": ms, "max_abs_err": err}
    return out


def timing_in_child() -> list:
    """Phase 9 in a fresh process (``chip_smoke.py --timing``, on the
    kernels this process built). Late in a long process torch.profiler
    lost the kernel records of short traces (the bitonic rows fell back
    to CUDA events, i.e. the host's launch rate); a fresh process keeps
    them whole."""
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--timing"], capture_output=True, text=True,
                         timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"timing phase failed ({out.returncode}):\n"
                           f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])["timed"]


# the timing lines' cases of this slice: the router's distance (its
# launches, one per routed session, beside the line), and the standalone
# sort and merge at the search's old proposal shapes (no path launches
# them: the fused Gather merge does their work)
ROUTER_CASE = "router shape (routed path)"
TIERED_CASE = (f"tiered shape (a frame buffer of {TIERED_TIMING_FRAMES} "
               "pages per shard)")
OLD_BITONIC_CASE = "search proposals' shape (no caller: the fused merge)"


def report_timing(timed, launches, errs, tiered_launches: int) -> list:
    """Print the timing lines with each kernel's launches on its path and
    its largest error against its plain version; returns the kernels'
    summary entries (the rows with a case only have a line of their
    own; the router's distance line carries its launches per routed
    session, the tiered one its launches in phase tiered's session)."""
    kernels = []
    for entry, line in timed:
        entry = {**entry, "max_abs_err": errs[entry["name"]]}
        if "case" not in line:
            entry["launches"] = launches[entry["name"]]
            kernels.append(entry)
        elif line["case"] == ROUTER_CASE:
            line = {**line, "launches_per_routed_session": 1}
        elif line["case"] == TIERED_CASE:
            line = {**line, "launches_per_tiered_session": tiered_launches}
        emit({"phase": "timing", **entry, **line})
    return kernels


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
    if sys.argv[1:] == ["--timing"]:     # phase 9, from timing_in_child
        build_all()
        print(json.dumps({"timed": time_kernels(dev)}), flush=True)
        return 0
    if sys.argv[1:2] == ["--distance-rows"]:
        import repro_torch
        build_all()
        print(json.dumps({"package": str(Path(repro_torch.__file__).parent),
                          **distance_rows(dev)}), flush=True)
        return 0
    if sys.argv[1:] == ["--restart-drill"]:   # phase 8c (d), drill_in_child
        torch.use_deterministic_algorithms(True)
        build_all()
        print(json.dumps(restart_drill()), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "cuda_graph_if_node": hasattr(torch.cuda.CUDAGraph,
                                        "begin_capture_to_if_node"),
          "allow_tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
          "allow_tf32_cudnn": torch.backends.cudnn.allow_tf32})

    emit({"phase": "build", "seconds": round(build_all(), 2),
          "ptxas": ptxas_report()})
    pool, main_build, routed_build, churn_build = start_host_builds()
    plan_pool, plan_pending = start_plan_cells()
    try:
        return run_phases(dev, name, main_build, routed_build, churn_build,
                          plan_pending)
    finally:
        for p in (pool, plan_pool):
            p.terminate()
            p.join()


def timed_part(phase: str, part: str, fn, *args):
    """``fn(*args)``, then a line with the phase's part and its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    emit({"phase": phase, "part": part,
          "seconds": round(time.perf_counter() - t0, 2)})
    return out


def run_phases(dev, name: str, main_build, routed_build, churn_build,
               plan_pending) -> int:
    """Phases 3 to 9; ``main_build``, ``routed_build`` and
    ``churn_build`` are the sift-1b builds (search, routed and phase
    live's churn set) running in child processes since phase 2,
    ``plan_pending`` phase plan's dry-run cells, run on the host since
    then too. The phases' integer parts run first, while the builds
    finish."""
    import torch

    t0 = time.perf_counter()
    T, qb, P, d, pages = main_path_tiles()
    errs = {"paged_distance": check_distance({
        "main path tiles": (T, qb, P, d, pages, True),
        "main path tiles, pages unsorted": (T, qb, P, d, pages, False),
        "1M-vector store": (T, qb, P, d, 2**20 // P, True),
        "router": ROUTER_TILES,
        "tiered frame buffer": (*tiered_tiles(), True)}, dev)}
    errs.update(check_distance_bf16({
        "main path tiles": (T, qb, P, d, pages, True),
        "1M-vector store": (T, qb, P, d, 2**20 // P, True),
        "router": ROUTER_TILES,
        "tiered frame buffer": (*tiered_tiles(), True)}, dev))
    errs["bitonic_sort"] = errs["bitonic_merge"] = \
        errs["bitonic_merge_unsorted"] = check_topk(dev)
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "seconds": round(time.perf_counter() - t0, 2)})
    t0 = time.perf_counter()
    errs["flash_attention"] = check_attention(dev)
    errs["flash_attention_bwd"] = check_attention_bwd(dev)
    torch.cuda.empty_cache()
    emit({"phase": "attn_kernels",
          "seconds": round(time.perf_counter() - t0, 2)})

    int_index = integer_main_path(dev)
    packed_int, queries_int, db_int = int_index
    timed_part("engine_variants", "integer", engine_variants_integer,
               packed_int, queries_int, dev)
    timed_part("stream", "integer", stream_integer, packed_int, queries_int,
               dev)
    tiered_build = timed_part("tiered", "integer", tiered_integer, db_int,
                              queries_int, dev)
    timed_part("live", "integer", live_integer, tiered_build, queries_int,
               dev)
    routed_int = timed_part("routed", "integer", routed_integer, db_int,
                            queries_int, dev)
    timed_part("mesh", "integer", mesh_integer, packed_int, queries_int,
               routed_int, dev)
    launches, (db, packed), main_run = real_main_path(dev, main_build)
    variants = timed_part("engine_variants", "sift-1b", engine_variants_sift,
                          dict(main_run, db=db), dev)
    # the bf16-query instantiation's path is payload_bf16's search
    launches["paged_distance_bf16q"] = \
        variants["payload_bf16"]["paged_distance_bf16q"]
    static = timed_part("stream", "sift-1b", stream_path, db, packed, dev)
    tiered = timed_part("tiered", "sift-1b", tiered_sift, db, packed, dev)
    timed_part("tiered", "capacity", capacity_check, dev)
    torch.cuda.empty_cache()
    timed_part("live", "sift-1b", live_sift, db, packed, static,
               churn_build, dev)
    torch.cuda.empty_cache()
    # the standalone sort and merge run on the routed path: their
    # launches are the sift topr-2 session's (route sort, fusion merges)
    routed = timed_part("routed", "sift-1b", routed_sift, dev, routed_build)
    launches["bitonic_sort"] = routed["bitonic_sort"]
    launches["bitonic_merge"] = routed["bitonic_merge"]
    timed_part("mesh", "sift-1b", mesh_sift, main_run, static, dev)
    torch.cuda.empty_cache()
    launches["flash_attention"] = timed_part(
        "serve", "all", serve_phases, dev)["flash_attention"]
    # the backward's launches: the training run's (26 per step)
    train_total, train_line = train_phase(dev)
    launches["flash_attention_bwd"] = train_total["flash_attention_bwd"]
    gc.collect()
    torch.cuda.empty_cache()
    mesh_total = train_mesh_phase(dev, train_line)
    if not all(mesh_total.get(k) for k in ("flash_attention",
                                           "flash_attention_bwd")):
        raise AssertionError(f"train_mesh: the path launched {mesh_total}")
    gc.collect()
    torch.cuda.empty_cache()
    counted = analysis_phase(dev, main_run)
    plan_phase(dev, counted, train_line, plan_pending)
    kernels = report_timing(timing_in_child(), launches, errs,
                            tiered["paged_distance"])
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
