"""Multi-pod dry run: plan every (arch x shape x mesh) cell and read one
device's roofline terms from the op stream of its step on "meta"
tensors (the reference's ``launch/dryrun.py``, which lowers and compiles
each cell for 512 placeholder TPU devices and reads the compiled HLO).
Nothing is allocated and no process group is opened: this runs on a
CPU.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma3-1b --shape train_4k \\
      --mesh single --out results/dryrun
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun
  python -m repro_torch.launch.dryrun --engine --mesh single  # the ANNS engine

One JSON record per cell, ``<arch>_<shape>_<mesh>[_kernelized].json``.

**Per-device operations and bytes.** ``launch/specs.py`` plans the cell;
the sharding rules (``models/sharding.py``) give one device's shapes
(:func:`device_config`): the batch divided by the FSDP size (data, or
pod x data); the heads, kv heads, head dim, d_ff, vocab rows, d_inner
and SSM heads divided by the model size where the activation table maps
them to "model", kept whole where it replicates them (where the heads
split but the kv heads do not, a device computes the kv heads its heads
read: K H_dev / H, at least 1); the parameters full on their FSDP
("embed") axes, as FSDP gathers them at use; a decode_long cache cut
along its sequence as the activation table says. The step runs at those
shapes under ``OpStream`` (``launch/opanalysis.py``): the hand-written
kernels report their declared cost on meta (``Kernel.shape_only``). A
train step is the trainer's pieces: the loss and its backward for one
microbatch (counted ``grad_accum`` times: every microbatch runs the same
ops), each gradient reduced to its FSDP shard as the backward produces
it (a post-accumulate hook) and accumulated as ``compute_grads`` does,
then the clip and ``update_step`` (AdamW, the NaN guard) on the
device's shards of the parameters and the optimizer state.

**Collective wire bytes per device** (received per device, ring
algorithms; f the FSDP size, m the model size, n = f m the devices;
|P| a parameter leaf's bytes at one device's compute shape, f_P = f if
its spec names an FSDP axis, else 1; G the grad-accum microbatches). A
train step's terms are what the sharded step (``train/trainer.py``
``make_train_step(mesh=)``) calls, counted by its collective wrapper
(``train/parallel.py``): per microbatch (times G) unless said. They
follow from where a block's function runs: once in the forward, and
under remat again in each recompute (``_block_runs``). torch's
checkpoint stops a recompute after the last tensor the backward saved,
so a block's innermost recompute stops before its MLP's (or MoE's)
output all-reduce; a group's recompute (scan_groups > 1) runs its
blocks but the last, whose input is all it needs; the hybrid's group
recompute runs all of its SSD layers and the shared block up to its
MLP's output all-reduce (the shared block saves tensors of its own).
Remat "dots" runs the same recomputes, stopped at the same ops (its
kept products leave the tensors the backward saves as they are), so it
counts as full; its operations and kept outputs come from the op stream.

  all-gather      FSDP: |P| (f_P - 1) / f_P per run of the leaf's block
                  function (full and stopped runs); a non-block leaf
                  (embedding, head, final norms, zamba2's shared block)
                  once, outside every remat; a serving step once.
  reduce-scatter  FSDP grads: |g_P| (f_P - 1) / f_P per leaf, at the
                  parameter dtype (the backward's gradient).
  all-reduce      data-parallel grads of leaves with f_P = 1:
                  2 |g_P| (f - 1) / f once per step, after the
                  accumulation (f32 under grad-accum).
                  kv leaves that "model" leaves whole while the heads
                  split (each rank reads its heads' kv slice): their
                  grad shards (every kv head) summed over "model",
                  2 |P_K| / f_P (m - 1) / m each; so are the SSD's B
                  and C projections and convolutions where d_inner
                  splits (every rank uses them whole for its own heads),
                  2 |P| / f_P (m - 1) / m each.
                  TP: 2 N (m - 1) / m per TP-reduced tensor, N = (micro
                  batch) x (rows) x d_model in the activation dtype:
                  where the heads split, the attention output per full
                  or stopped run and its input once in the backward;
                  where d_ff splits, the MLP or MoE output per full run
                  and its input once in the backward, and the MoE's gate
                  weights (rows x k) once in the backward; where
                  d_inner splits the SSD output as the MLP's, and its
                  gated norm's statistic, (micro batch) x (rows) x 4
                  bytes, per full or stopped run and once in the
                  backward; the encoder's blocks as the decoder's, the
                  cross-attention as the self-attention, and the
                  encoder's output once in the backward (every rank's
                  cross-attention reads it); where the vocab splits,
                  the embedding once (forward), and per loss chunk of C
                  rows the row max (4 bytes per row) and the sums of exp
                  and of the label's logit (8) in the forward and the
                  chunk's recompute, and the chunk's hidden once in the
                  backward. Decode with a head-dim-sharded cache also
                  reduces its scores, (B, H, cache rows) f32, per
                  attention layer. decode_long (a cache cut along its
                  sequence over all n devices) combines each attention
                  layer's partial output and its softmax max and sum
                  over n. Scalar reductions (the loss's three sums over
                  the data axes, the norm, the NaN guard, the MoE's
                  statistics) are not counted.

An axis of at most 8 ranks sits inside one HGX H100 node and runs on
NVLink; a larger axis crosses nodes on InfiniBand (``LINKS``). With the
reference's 16-way axes every axis crosses nodes, the model axis
included: the record says so in ``links``.

**Peak memory per device**: the argument bytes (parameters, optimizer
state and inputs at their local shapes, ``Planned.local_bytes``), plus
the gathered weights of the largest unit (one block, or one non-block
leaf) when FSDP shards them, plus the larger of the two phases' peaks
of live meta storage (``OpStream(track_memory=True)``): the
microbatch's forward and backward (with its gradient shards), and the
update (from the gradients, which the clip replaces).

``--engine``: the paper's engine at the reference's geometry (S = 256
or 512 shards, pages of 256 vectors, 64 pages per shard, d 128, degree
32, 8 queries per shard, L 32): one meta round of the sim stepper
(``core/engine.py`` ``_sim_round``), its operations and bytes divided by
S, and its four exchanges' bucket tensors as all-to-alls at world S
(``_mesh_exchange``): (S - 1) / S of each rank's buckets cross the
wire. Bucket capacities are the lossless static ones (the most a round
can hold).

Not modelled: measured NCCL time (no card cluster here); overlap of
collectives with compute (the bound takes the largest term); prefill's
reshard of K/V into a head-dim-sharded cache.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.mesh import (FSDP_AXES, axis_sizes,
                                     make_production_mesh)
from repro_torch.launch.opanalysis import OpStream, summarize
from repro_torch.launch.specs import (ENCDEC_DECODE_ENC_LEN, HBM_PER_CHIP,
                                      Skip, all_cells, plan_cell,
                                      planned_leaves, step_for)
from repro_torch.models import transformer as T
from repro_torch.models.convert import STACKED
from repro_torch.models.params import (module_tree, pspec_axes, pspec_of,
                                       spec_leaves, spec_paths)
from repro_torch.models.ssm import MODEL_SUMMED
from repro_torch.optim.adamw import OptConfig, clip_by_global_norm
from repro_torch.train.trainer import TrainConfig, update_step
from repro_torch.utils import as_tree, tree_leaves, tree_map

# Hardware model: NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
# datasheet, SXM column)
PEAK_BF16 = 989e12           # dense BF16 tensor-core FLOP/s
PEAK_F32 = 67e12             # FP32 FLOP/s (no TF32)
HBM_BW = 3.35e12             # HBM3 bytes/s
HBM_BYTES = HBM_PER_CHIP     # 80 GB
NODE_GPUS = 8                # GPUs per HGX H100 node, NVLink all to all
NVLINK_BW = 450e9            # NVLink 4: 900 GB/s per GPU, 450 each way
IB_BW = 50e9                 # one 400 Gb/s NDR InfiniBand port per GPU
LINKS = {"nvlink": NVLINK_BW, "infiniband": IB_BW}



def link_of(ranks: int) -> tuple:
    """(fabric, bytes/s) of a collective over ``ranks`` ranks."""
    fabric = "nvlink" if ranks <= NODE_GPUS else "infiniband"
    return fabric, LINKS[fabric]


def _prod(xs) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# --------------------------------------------------------------------------
# Analytic FLOPs (the reference's formulas)
# --------------------------------------------------------------------------
def model_flops(arch: str, shape_name: str) -> float:
    """Analytic useful FLOPs for the whole cell (all devices):
    6*N*D train, 2*N*D inference; N_active for MoE."""
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    n = cfg.param_count()
    if cfg.is_moe:
        # active params: replace E experts by top-k experts per token
        full_ffn = cfg.num_experts * 3 * cfg.d_model * cfg.d_ff
        act_ffn = cfg.num_experts_per_tok * 3 * cfg.d_model * cfg.d_ff
        n = n - (full_ffn - act_ffn) * cfg.num_layers
    if shp.kind == "train":
        tokens = shp.global_batch * shp.seq_len
        return 6.0 * n * tokens
    if shp.kind == "prefill":
        return 2.0 * n * shp.global_batch * shp.seq_len
    return 2.0 * n * shp.global_batch          # decode: one token per seq


def attn_kernel_flops(arch: str, shape: str, *, train: bool) -> float:
    """Analytic flops of the fused attention kernel over all devices:
    4*B*sum_l(S*S_eff_l)*H*hd, causal halves S_eff, sliding windows cap
    it; backward ~2.5x forward."""
    cfg = get_config(arch)
    shp = SHAPES[shape]
    B, S = shp.global_batch, shp.seq_len
    if cfg.attn_free or shp.kind == "decode":
        return 0.0
    total = 0.0
    wins = (cfg.layer_windows() if cfg.family != "hybrid"
            else [cfg.window] * (cfg.num_layers // max(
                cfg.hybrid_attn_every, 1)))
    for w in wins:
        s_eff = S / 2 if not w else min(w, S / 2)
        total += 4.0 * B * S * s_eff * cfg.num_heads * cfg.head_dim
    if cfg.family == "encdec":
        total += 4.0 * B * S * (S / 2) * cfg.num_heads * cfg.head_dim \
            * cfg.enc_layers / max(cfg.num_layers, 1)
    if train:
        total *= 3.5          # fwd + recompute + dq/dk/dv passes
    return total               # TOTAL across devices; caller divides


# --------------------------------------------------------------------------
# One device's shapes
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DeviceConfig(ArchConfig):
    """One device's share of a model: an ``ArchConfig`` whose vocab rows
    and SSD inner width are set, not derived (a model-axis cut need not
    keep them multiples of 256 or of ``ssm_expand``)."""

    vocab_rows: int = 0
    inner: int = 0

    def vocab_padded(self, multiple: int = 256) -> int:
        return self.vocab_rows

    @property
    def d_inner(self) -> int:
        return self.inner

    @property
    def ssm_heads(self) -> int:
        return self.inner // self.ssm_headdim if self.ssm_state else 0


def _factor(entry, sizes) -> int:
    return _prod(sizes[a] for a in pspec_axes(entry))


def device_config(cfg: ArchConfig, rules, sizes: dict) -> DeviceConfig:
    """``cfg`` cut as the activation table of ``rules`` cuts it over the
    mesh axis ``sizes`` (the module doc)."""
    acts = rules.acts

    def cut(n, name):
        return n // _factor(acts.lookup(name), sizes) if n else n

    H = cut(cfg.num_heads, "heads")
    K = cut(cfg.num_kv_heads, "kv_heads")
    if H and H % K:
        K = max(1, K * H // cfg.num_heads)
    if H and H % K:
        raise ValueError(f"{cfg.name}: {H} heads per device do not group "
                         f"over {K} kv heads")
    inner = cut(cfg.d_inner, "ssm_inner")
    if cfg.ssm_state and inner // cfg.ssm_headdim != cut(cfg.ssm_heads,
                                                         "ssm_heads"):
        raise ValueError(f"{cfg.name}: d_inner and the SSM heads split "
                         f"differently")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(ArchConfig)}
    vrows = cut(cfg.vocab_padded(), "vocab")
    fields.update(num_heads=H, num_kv_heads=K,
                  head_dim=cut(cfg.head_dim, "head_dim"),
                  d_ff=cut(cfg.d_ff, "ffn"), vocab_size=vrows)
    return DeviceConfig(**fields, vocab_rows=vrows, inner=inner)


def _param_rows(plan, cfg_d) -> list:
    """Per compute leaf: (path top key, meta-free spec of one device's
    compute shape, its global spec's FSDP factor over the mesh, its
    logical axis names, its name in its subtree)."""
    sizes = axis_sizes(plan.rules.mesh)
    out = []
    for key in T.model_spec(plan.cfg):
        g = spec_leaves(T.model_spec(plan.cfg)[key])
        d = spec_leaves(T.model_spec(cfg_d)[key])
        paths = spec_paths(T.model_spec(plan.cfg)[key])
        for gs, ds, path in zip(g, d, paths):
            ps = pspec_of(gs, plan.rules.params)
            f = _prod(sizes[a] for e in ps for a in pspec_axes(e)
                      if a in FSDP_AXES)
            out.append((key, ds, f, gs.names, path[-1]))
    return out


def _shard_shape(shape, gspec, rules, sizes) -> tuple:
    """A compute leaf's shape cut on its FSDP axes (its grad's shard)."""
    ps = pspec_of(gspec, rules.params)
    out = []
    for i, dim in enumerate(shape):
        e = ps[i] if i < len(ps) else None
        out.append(dim // _prod(sizes[a] for a in pspec_axes(e)
                                if a in FSDP_AXES))
    return tuple(out)


# --------------------------------------------------------------------------
# Collectives (the module doc's formulas)
# --------------------------------------------------------------------------
class _Wire:
    """Collective wire bytes per device, by kind and by axis group."""

    def __init__(self, sizes: dict):
        self.sizes = sizes
        self.rows: list = []

    def add(self, kind: str, axis: str, ranks: int, nbytes: float,
            count: int = 1) -> None:
        if ranks > 1 and nbytes > 0 and count > 0:
            self.rows.append((kind, axis, ranks, float(nbytes), count))

    def ring_gather(self, axis, ranks, full, count=1):
        self.add("all-gather", axis, ranks, full * (ranks - 1) / ranks,
                 count)

    def ring_scatter(self, axis, ranks, full, count=1):
        self.add("reduce-scatter", axis, ranks,
                 full * (ranks - 1) / ranks, count)

    def ring_reduce(self, axis, ranks, n, count=1):
        self.add("all-reduce", axis, ranks, 2 * n * (ranks - 1) / ranks,
                 count)

    def report(self) -> dict:
        by_kind, count, by_axis = {}, {}, {}
        for kind, axis, ranks, b, c in self.rows:
            by_kind[kind] = by_kind.get(kind, 0.0) + b * c
            count[kind] = count.get(kind, 0) + c
            a = by_axis.setdefault(axis, {"ranks": ranks, "bytes": 0.0})
            a["bytes"] += b * c
        total = sum(by_kind.values())
        seconds = 0.0
        for a in by_axis.values():
            a["fabric"], rate = link_of(a["ranks"])
            a["seconds"] = a["bytes"] / rate
            seconds += a["seconds"]
        return {"bytes_by_kind": by_kind, "count_by_kind": count,
                "by_axis": by_axis, "total_bytes": total,
                "seconds": seconds}


def _stack_runs(n: int, remat: str, groups: int) -> list:
    """(full runs, stopped runs) of each block function of an ``n``-block
    stack run by ``models/transformer.py`` ``scan_layers`` in training
    (module doc)."""
    if remat == "none":
        return [(1, 0)] * n
    g = T.pick_groups(n, groups) if n else 1
    if g == 1:
        return [(1, 1)] * n
    per = n // g
    return [(1 + int(j % per < per - 1), 1) for j in range(n)]


def _block_runs(plan) -> dict:
    """{"blocks": [...], "enc_blocks": [...]}: each block's (full runs,
    stopped runs) in a train microbatch (module doc)."""
    cfg, opts = plan.cfg, plan.opts
    out = {}
    if cfg.family == "hybrid":
        G, e, tail = T.hybrid_layout(cfg)
        grouped = [(2, 1) if opts.remat != "none" else (1, 0)] * (G * e)
        out["blocks"] = grouped + _stack_runs(tail, opts.remat, 1)
    else:
        out["blocks"] = _stack_runs(cfg.num_layers, opts.remat,
                                    opts.scan_groups)
    if cfg.family == "encdec":
        out["enc_blocks"] = _stack_runs(cfg.enc_layers, opts.remat,
                                        opts.scan_groups)
    return out


def _model_collectives(plan, cfg_d, wire: _Wire, rows_q: int, B_mb: int,
                       cache_rows: int, act_bytes: int, G: int = 1) -> None:
    """The TP all-reduces (and decode's cache combines) of a train step's
    G microbatches, or of a serving step (module doc)."""
    cfg, sizes = plan.cfg, wire.sizes
    m = sizes.get("model", 1)
    n = _prod(sizes.values())
    kind = plan.rules_kind
    train = plan.kind == "train"
    N = B_mb * rows_q * cfg.d_model * act_bytes
    heads = cfg_d.num_heads < cfg.num_heads
    ffn = cfg_d.d_ff < cfg.d_ff
    inner = bool(cfg.ssm_state) and cfg_d.d_inner < cfg.d_inner
    L, fam = cfg.num_layers, cfg.family
    attn_layers = L if fam in ("dense", "vlm", "moe", "encdec") else 0
    if fam == "hybrid":
        attn_layers = T.hybrid_layout(cfg)[0]
    if not train:
        points = attn_layers * (int(heads) + int(ffn))
        if fam == "encdec":
            points += L * int(heads)           # cross-attention
            wire.ring_reduce("model", m, B_mb * (
                rows_q if plan.kind != "decode" else 0) * cfg.d_model
                * act_bytes, cfg.enc_layers * (int(heads) + int(ffn)))
        if fam in ("ssm", "hybrid"):
            points += L * int(inner)
        wire.ring_reduce("model", m, N, points)
        if cfg_d.vocab_size < cfg.vocab_padded():
            wire.ring_reduce("model", m, N, 1)  # vocab-parallel embedding
    else:
        runs = _block_runs(plan)
        attn = ffn_n = 0
        if fam in ("dense", "vlm", "moe", "encdec"):
            for full, stopped in runs["blocks"]:
                attn += (full + stopped + 1) * (1 + int(fam == "encdec"))
                ffn_n += full + 1
            if fam == "moe" and ffn:
                wire.ring_reduce("model", m, B_mb * rows_q
                                 * cfg.num_experts_per_tok * act_bytes,
                                 L * G)        # the gate weights' grads
        if fam == "encdec":
            enc = B_mb * rows_q * cfg.d_model * act_bytes
            e_attn = sum(f + s + 1 for f, s in runs["enc_blocks"])
            e_ffn = sum(f + 1 for f, _ in runs["enc_blocks"])
            # + the encoder's output, read by every cross-attention
            wire.ring_reduce("model", m, enc, G * (
                (e_attn + 1) * int(heads) + e_ffn * int(ffn)))
        if fam == "hybrid":
            # the shared block ends each group: the group's forward runs
            # it whole, its recompute stops before the MLP's output
            # all-reduce (nothing after it is saved), then its backward
            Gh = T.hybrid_layout(cfg)[0]
            attn = Gh * (3 if plan.opts.remat != "none" else 2)
            ffn_n = 2 * Gh
        if fam in ("ssm", "hybrid"):
            wire.ring_reduce("model", m, N, G * int(inner) * sum(
                f + 1 for f, _ in runs["blocks"]))
            wire.ring_reduce("model", m, B_mb * rows_q * 4,
                             G * int(inner) * sum(
                                 f + s + 1 for f, s in runs["blocks"]))
        wire.ring_reduce("model", m, N,
                         G * (attn * int(heads) + ffn_n * int(ffn)))
        if cfg_d.vocab_size < cfg.vocab_padded():
            C = min(plan.opts.loss_chunk, rows_q)
            chunks = -(-rows_q // C)
            wire.ring_reduce("model", m, N, G)          # the embedding
            wire.ring_reduce("model", m, B_mb * C * 4, 2 * chunks * G)
            wire.ring_reduce("model", m, B_mb * C * 8, 2 * chunks * G)
            wire.ring_reduce("model", m, B_mb * C * cfg.d_model
                             * act_bytes, chunks * G)
    if kind == "decode" and cfg_d.head_dim < cfg.head_dim and attn_layers:
        wire.ring_reduce("model", m,
                         B_mb * cfg_d.num_heads * cache_rows * 4,
                         attn_layers)
        wire.ring_reduce("model", m, N, attn_layers)
    if kind == "decode_long" and attn_layers:
        per = B_mb * cfg.num_heads * (cfg.head_dim * act_bytes + 8)
        wire.ring_reduce("all", n, per, attn_layers)


def _param_collectives(plan, cfg_d, wire: _Wire, grad_bytes: int,
                       G: int = 1) -> None:
    """The FSDP gathers, grad reduce-scatters, kv grads' model sums and
    data-parallel grad all-reduces of a train step's G microbatches, or
    the gathers of a serving step (module doc)."""
    sizes = wire.sizes
    f = _prod(sizes.get(a, 1) for a in FSDP_AXES)
    m = sizes.get("model", 1)
    train = plan.kind == "train"
    pbytes = torch.empty((), dtype=plan.policy.param_dtype).element_size()
    runs = _block_runs(plan) if train else {}
    kv_whole = (plan.rules.params.lookup("heads") == "model" and m > 1
                and plan.rules.params.lookup("kv_heads") is None)
    inner = bool(plan.cfg.ssm_state) and cfg_d.d_inner < plan.cfg.d_inner
    seen = {}
    for key, ds, fp, names, leaf in _param_rows(plan, cfg_d):
        full = _prod(ds.shape) * pbytes
        uses = 1
        if train and key in STACKED:
            # the leaves of a stacked subtree come block by block
            i = seen[key] = seen.get(key, -1) + 1
            per = len(spec_leaves(T.model_spec(plan.cfg)[key][0]))
            uses = sum(runs[key][i // per])
        if fp > 1:
            wire.ring_gather("fsdp", fp, full, uses * G)
        if not train:
            continue
        if fp > 1:
            wire.ring_scatter("fsdp", fp, full, G)
        else:
            wire.ring_reduce("fsdp", f, _prod(ds.shape) * grad_bytes)
        if kv_whole and "kv_heads" in names:
            # the sum runs on the whole shard: every kv head, read or not
            wire.ring_reduce("model", m, full / fp * plan.cfg.num_kv_heads
                             / cfg_d.num_kv_heads, G)
        if inner and key == "blocks" and leaf in MODEL_SUMMED:
            wire.ring_reduce("model", m, full / fp, G)


# --------------------------------------------------------------------------
# One device's step on meta tensors
# --------------------------------------------------------------------------
def _local_meta(tree, mesh):
    """A tree of Planned -> meta tensors of their local shapes."""
    if isinstance(tree, dict):
        return {k: _local_meta(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local_meta(v, mesh) for v in tree]
    return _meta(tree.local_shape(mesh), tree.dtype)


def _largest_unit(plan, cfg_d) -> int:
    """Bytes of the largest unit FSDP gathers at once: one block, or one
    non-block leaf, at one device's compute shape."""
    pbytes = torch.empty((), dtype=plan.policy.param_dtype).element_size()
    best = 0
    spec = T.model_spec(cfg_d)
    for key, sub in spec.items():
        units = sub if key in STACKED else [sub] if key == "shared" \
            else spec_leaves(sub)
        for u in units:
            best = max(best, sum(_prod(s.shape) for s in spec_leaves(u))
                       * pbytes)
    return best


def _cache_meta(cfg_d, B, rows, enc_len):
    """The decode cache on meta tensors: bf16 k/v, f32 states, and
    ``pos`` and ``enc_len`` 0-d int32, as ``T.init_cache`` makes them (a
    meta scalar holds no value, and no step reads one on the host)."""
    cache = {}
    for name, shape in T.cache_spec(cfg_d, B, rows, enc_len=enc_len).items():
        if name in ("pos", "enc_len"):
            cache[name] = _meta((), torch.int32)
        elif name in ("ssm", "conv"):
            cache[name] = _meta(shape, torch.float32)
        else:
            cache[name] = [_meta(s, torch.bfloat16) for s in shape]
    return cache


def analyze_plan(plan) -> dict:
    """One device's operations, bytes, collective wire bytes, memory and
    roofline terms for a cell plan on the mesh it was planned for
    (module doc)."""
    mesh = plan.rules.mesh
    sizes = axis_sizes(mesh)
    n = _prod(sizes.values())
    cfg, pol, opts = plan.cfg, plan.policy, plan.opts
    cfg_d = device_config(cfg, plan.rules, sizes)
    tokens = plan.args[2]["tokens"] if plan.kind == "train" \
        else plan.args[2]
    B, S = tokens.shape
    bfac = _factor(plan.rules.acts.lookup("batch"), sizes)
    B_loc = B // bfac
    G = pol.grad_accum if plan.kind == "train" else 1
    if B_loc % G:
        raise ValueError(f"{B_loc} rows per device do not split into "
                         f"{G} microbatches")
    B_mb = B_loc // G
    act_bytes = torch.empty((), dtype=opts.act_dtype).element_size()
    wire = _Wire(sizes)
    pdt = pol.param_dtype
    params_c = module_tree(T.model_spec(cfg_d),
                           lambda _, s: _meta(s.shape, pdt))
    arg_parts = {"params": sum(p.local_bytes(mesh)
                               for p in planned_leaves(plan.args[0]))}
    fsdp_params = any(r[2] > 1 for r in _param_rows(plan, cfg_d))
    gather = _largest_unit(plan, cfg_d) if fsdp_params else 0

    if plan.kind == "train":
        arg_parts["opt"] = sum(p.local_bytes(mesh)
                               for p in planned_leaves(plan.args[1]))
        arg_parts["inputs"] = sum(p.local_bytes(mesh)
                                  for p in planned_leaves(plan.args[2]))
        records, temp = _train_records(plan, cfg_d, params_c, B_mb, S)
        train_collectives(plan, wire)
    else:
        arg_parts["inputs"] = sum(
            p.local_bytes(mesh) for a in plan.args[1:]
            for p in planned_leaves(a))
        records, temp, rows = _serve_records(plan, cfg_d, params_c, B_loc,
                                             S)
        _param_collectives(plan, cfg_d, wire, 0)
        _model_collectives(plan, cfg_d, wire,
                           S if plan.kind == "prefill" else 1, B_loc, rows,
                           act_bytes)
    rep = summarize(records)
    coll = wire.report()
    arg = sum(arg_parts.values())
    peak = arg + gather + temp

    def rate(dt):
        return PEAK_BF16 if dt in (torch.bfloat16, torch.float16) \
            else PEAK_F32
    t_comp = sum(r.flops / rate(r.dtype or opts.act_dtype) for r in records)
    t_mem = rep["hbm_bytes"] / HBM_BW
    t_coll = coll["seconds"]
    return {
        "devices": n,
        "device_config": {"batch": B_loc, "microbatch": B_mb,
                          "grad_accum": G, "heads": cfg_d.num_heads,
                          "kv_heads": cfg_d.num_kv_heads,
                          "head_dim": cfg_d.head_dim, "d_ff": cfg_d.d_ff,
                          "vocab_rows": cfg_d.vocab_rows,
                          "d_inner": cfg_d.d_inner},
        "memory": {"argument_bytes": arg, "argument_parts": arg_parts,
                   "gather_bytes": gather, "temp_bytes": temp,
                   "peak_bytes_per_device": peak,
                   "fits_hbm": bool(peak <= HBM_BYTES)},
        "per_device": {"flops": rep["flops"], "hbm_bytes": rep["hbm_bytes"],
                       "ops": len(records),
                       "collective_bytes": coll["total_bytes"],
                       "collectives": coll, "kernels": rep["kernels"]},
        "roofline": _roofline(t_comp, t_mem, t_coll),
    }


def train_collectives(plan, wire: _Wire | None = None) -> _Wire:
    """The collectives of a train cell's step on one device (module doc):
    ``wire`` (a new one by default) with its rows added."""
    sizes = axis_sizes(plan.rules.mesh)
    wire = _Wire(sizes) if wire is None else wire
    cfg_d = device_config(plan.cfg, plan.rules, sizes)
    B, S = plan.args[2]["tokens"].shape
    G = plan.policy.grad_accum
    B_mb = B // _factor(plan.rules.acts.lookup("batch"), sizes) // G
    act_bytes = torch.empty((), dtype=plan.opts.act_dtype).element_size()
    grad_bytes = 4 if G > 1 else torch.empty(
        (), dtype=plan.policy.param_dtype).element_size()
    _param_collectives(plan, cfg_d, wire, grad_bytes, G)
    _model_collectives(plan, cfg_d, wire, S, B_mb, 0, act_bytes, G)
    return wire


def _roofline(t_comp, t_mem, t_coll) -> dict:
    terms = (("compute", t_comp), ("memory", t_mem), ("collective", t_coll))
    return {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll,
            "dominant": max(terms, key=lambda kv: kv[1])[0],
            "step_s_lower_bound": max(t_comp, t_mem, t_coll)}


def _train_records(plan, cfg_d, params_c, B_mb, S):
    """(op records of one train step, temp bytes): the microbatch's loss
    and backward (its records counted grad_accum times) and the update
    on the device's shards (module doc)."""
    mesh = plan.rules.mesh
    sizes = axis_sizes(mesh)
    pol, opts = plan.policy, plan.opts
    G = pol.grad_accum
    tc = TrainConfig(grad_accum=G)
    leaves = tree_leaves(as_tree(params_c))
    gspecs = spec_leaves(T.model_spec(plan.cfg))
    shards = [_shard_shape(tuple(p.shape), gs, plan.rules, sizes)
              for p, gs in zip(leaves, gspecs)]
    ins = plan.args[2]
    mb = {"tokens": _meta((B_mb, S), ins["tokens"].dtype),
          "labels": _meta((B_mb, S), ins["labels"].dtype)}
    if "frontend" in ins:
        mb["frontend"] = _meta((B_mb,) + ins["frontend"].shape[1:],
                               ins["frontend"].dtype)
    acc = [None] * len(leaves)

    def hook(i):
        def reduce(p):
            # the grad's FSDP shard (a reduce-scatter's output), then
            # compute_grads' accumulation
            g = p.grad if shards[i] == tuple(p.shape) else \
                p.grad.new_empty(shards[i])
            acc[i] = g if G == 1 else acc[i] + g.float() / G
            p.grad = None
        return reduce

    handles = []
    for i, p in enumerate(leaves):
        p.requires_grad_(True)
        handles.append(p.register_post_accumulate_grad_hook(hook(i)))
    try:
        with OpStream(track_memory=True) as s1:
            if G > 1:
                acc[:] = [torch.zeros(sh, dtype=torch.float32, device="meta")
                          for sh in shards]
            n0 = len(s1.records)
            loss, _ = T.loss_fn(params_c, cfg_d, mb, opts=opts,
                                lb_coef=tc.lb_coef)
            loss.backward()
    finally:
        for h in handles:
            h.remove()
    gdt = acc[0].dtype
    del params_c, leaves, acc
    # the update on this device's shards of the parameters and the state,
    # from the grads compute_grads hands over (made in the stream, so the
    # clip's rebinding frees them as the trainer's does)
    p_sh = _local_meta(plan.args[0], mesh)
    opt = _local_meta(plan.args[1], mesh)
    oc = OptConfig(m_dtype=pol.m_dtype, v_dtype=pol.v_dtype,
                   factored_v=pol.factored_v)
    with OpStream(track_memory=True) as s2:
        grads = tree_map(lambda p: _meta(p.shape, gdt), p_sh)
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
        update_step(p_sh, grads, gnorm, loss.detach(), opt, oc)
    records = s1.records[:n0] + s1.records[n0:] * G + s2.records
    return records, max(s1.peak_bytes, s2.peak_bytes)


def _serve_records(plan, cfg_d, params_c, B_loc, S):
    """(op records of one prefill or decode step, temp bytes, the cache
    rows one device attends over)."""
    sizes = axis_sizes(plan.rules.mesh)
    cfg = plan.cfg
    seq = _factor(plan.rules.acts.lookup("seq"), sizes)
    rows = S // seq
    enc = (S if plan.kind == "prefill" else ENCDEC_DECODE_ENC_LEN) \
        if cfg.family == "encdec" else 0
    cache = _cache_meta(cfg_d, B_loc, rows, enc)
    args = [params_c, cache,
            _meta((B_loc, S if plan.kind == "prefill" else 1), torch.int32)]
    if len(plan.args) > 3:         # prefill's frontend input
        args.append(_meta((B_loc,) + plan.args[3].shape[1:],
                          plan.args[3].dtype))
    step = step_for(plan.kind, cfg_d, plan.opts, plan.policy)
    with OpStream(track_memory=True) as s:
        step(*args)
    return s.records, s.peak_bytes, rows


# --------------------------------------------------------------------------
# Cells
# --------------------------------------------------------------------------
def _links(sizes: dict) -> dict:
    out = {}
    for a, r in sizes.items():
        fabric, rate = link_of(r)
        out[a] = {"ranks": r, "fabric": fabric, "bytes_per_s": rate}
    f = _prod(sizes.get(a, 1) for a in FSDP_AXES)
    fabric, rate = link_of(f)
    out["fsdp"] = {"ranks": f, "fabric": fabric, "bytes_per_s": rate}
    return out


def _link_note(sizes: dict) -> str:
    wide = [f"{a} ({r} ranks)" for a, r in sizes.items() if r > NODE_GPUS]
    if not wide:
        return f"every axis fits one {NODE_GPUS}-GPU node: NVLink"
    return (", ".join(wide) + f" span more than one {NODE_GPUS}-GPU HGX "
            f"node: their collectives cross InfiniBand "
            f"({IB_BW / 1e9:.0f} GB/s per GPU)"
            + (", the model axis's all-reduces included"
               if sizes.get("model", 1) > NODE_GPUS else ""))


def run_cell(arch: str, shape: str, mesh_kind: str,
             attn_stub: bool = False, remat: str | None = None) -> dict:
    """One cell's record; ``remat`` replaces a train cell's remat policy
    (``plan_cell``)."""
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    sizes = axis_sizes(mesh)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_kind,
           "mesh_shape": list(sizes.values()), "status": "ok"}
    t0 = time.time()
    try:
        plan = plan_cell(arch, shape, mesh, remat=remat)
    except Skip as e:
        rec.update(status="skip", reason=str(e))
        return rec
    rec["kind"] = plan.kind
    rec["note"] = plan.note
    if remat is not None:
        rec["remat"] = plan.opts.remat
    try:
        rec.update(analyze_plan(plan))
        rec["links"] = _links(sizes)
        rec["link_note"] = _link_note(sizes)
        mf = model_flops(arch, shape)
        rec["model_flops_total"] = mf
        fl = rec["per_device"]["flops"]
        rec["useful_flops_ratio"] = mf / (fl * rec["devices"]) if fl else 0.0
        if attn_stub:
            # kernelized variant: the flash kernels' declared operations
            # replaced by the analytic count (the reference's stub)
            n = rec["devices"]
            ker = rec["per_device"]["kernels"]
            declared = sum(ker.get(k, {}).get("flops", 0.0) for k in
                           ("flash_attention", "flash_attention_bwd"))
            extra = attn_kernel_flops(arch, shape,
                                      train=(plan.kind == "train")) / n
            rl = rec["roofline"]
            rl.update(_roofline(rl["compute_s"] + (extra - declared)
                                / PEAK_BF16, rl["memory_s"],
                                rl["collective_s"]))
            rec["variant"] = "kernelized-attention"
            rec["analytic_attn_flops_per_dev"] = extra
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["trace_s"] = round(time.time() - t0, 2)
    return rec


def run_engine_cell(batch_per_shard: int = 8, dim: int = 128,
                    max_degree: int = 32, pages_per_shard: int = 64,
                    mesh_kind: str = "single", num_shards: int = 0) -> dict:
    """The paper's engine, one LUN group per device (module doc).
    ``num_shards`` overrides the mesh's 256 / 512 (a small test)."""
    from repro_torch.core.engine import (EngineGeom, EngineParams, _exchange,
                                         _qq, _sim_round, _widths,
                                         engine_init)
    from repro_torch.core.ref_search import SearchParams

    S = num_shards or (256 if mesh_kind == "single" else 512)
    page = 256
    geom = EngineGeom(num_shards=S, page_size=page, pages_per_block=8,
                      pages_per_shard=pages_per_shard, dim=dim,
                      max_degree=max_degree, spec_stored=0,
                      n=S * pages_per_shard * page)
    sp = SearchParams(L=32, W=1, k=10, max_rounds=48)
    params = EngineParams.lossless(sp, batch_per_shard, max_degree)
    n_local = pages_per_shard * page
    consts = {
        "db": _meta((S, pages_per_shard, page, dim), torch.float32),
        "vnorm": _meta((S, pages_per_shard, page), torch.float32),
        "adj": _meta((S, n_local, max_degree), torch.int32),
        "pref": _meta((S, n_local, 0), torch.int32),
        "blk_perm": _meta((S, pages_per_shard // 8), torch.int32),
    }
    queries = _meta((S, batch_per_shard, dim), torch.float32)
    rec = {"arch": "ndsearch-engine", "shape": f"batch{S * batch_per_shard}",
           "mesh": mesh_kind, "mesh_shape": [S], "status": "ok",
           "kind": "search"}
    t0 = time.time()
    try:
        state = engine_init(consts, queries, _meta((dim,), torch.float32),
                            _meta((), torch.float32), 0, params, geom)
        buckets = []

        def tally(tree):
            buckets.append(sum(v.numel() * v.element_size()
                               for v in tree.values()))
            return _exchange(tree)

        with OpStream(track_memory=True) as st:
            _sim_round(state, consts, queries, _qq(queries),
                       _widths(params.spec_width, queries.shape[:2],
                               queries.device), params, geom,
                       exchange=tally)
        rep = summarize(st.records)
        wire = _Wire({"lun": S})
        for b in buckets:      # one all-to-all per bucket tensor
            wire.add("all-to-all", "lun", S, b / S * (S - 1) / S)
        wire.ring_reduce("lun", S, 4)      # the loop condition's count
        coll = wire.report()
        flops, nbytes = rep["flops"] / S, rep["hbm_bytes"] / S
        arg = sum(t.numel() * t.element_size() for t in
                  list(consts.values()) + [queries]) / S
        state_bytes = sum(t.numel() * t.element_size() for t in state
                          if isinstance(t, torch.Tensor)) / S
        rec.update({
            "devices": S,
            "memory": {"argument_bytes": arg + state_bytes,
                       "temp_bytes": st.peak_bytes / S,
                       "peak_bytes_per_device": arg + state_bytes
                       + st.peak_bytes / S,
                       "fits_hbm": bool(arg + state_bytes + st.peak_bytes
                                        / S <= HBM_BYTES)},
            "per_device": {"flops": flops, "hbm_bytes": nbytes,
                           "ops": len(st.records),
                           "collective_bytes": coll["total_bytes"],
                           "collectives": coll,
                           "kernels": {k: {kk: v / S if kk != "launches"
                                           else v for kk, v in e.items()}
                                       for k, e in rep["kernels"].items()},
                           "bucket_bytes": buckets},
            "note": "per-ROUND costs of one device (the sim round's "
                    "totals / S); bucket capacities are the lossless "
                    "static ones",
            "roofline": _roofline(
                sum(r.flops for r in st.records) / S / PEAK_F32,
                nbytes / HBM_BW, coll["seconds"]),
            "links": _links({"lun": S}),
            "link_note": _link_note({"lun": S}),
        })
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["trace_s"] = round(time.time() - t0, 2)
    return rec


def record_name(rec: dict) -> str:
    suffix = "_kernelized" if rec.get("variant") else ""
    if "remat" in rec:
        suffix += f"_remat-{rec['remat']}"
    return f"{rec['arch']}_{rec['shape']}_{rec['mesh']}{suffix}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--attn-stub", action="store_true",
                    help="kernelized-attention roofline variant")
    ap.add_argument("--remat", choices=T.REMAT,
                    help="a train cell's remat policy (default: the "
                         "plan's, full); dots keeps the batch-free "
                         "products, as the reference's "
                         "dots_with_no_batch_dims_saveable")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    def emit(rec):
        with open(os.path.join(args.out, record_name(rec)), "w") as f:
            json.dump(rec, f, indent=1)
        r = rec.get("roofline", {})
        line = (f"[{rec['status']:5s}] {rec['arch']:24s} {rec['shape']:12s} "
                f"{rec['mesh']:6s}")
        if rec["status"] == "ok" and r:
            line += (f" dom={r.get('dominant', '?'):10s}"
                     f" comp={r['compute_s']:.3e} mem={r['memory_s']:.3e}"
                     f" coll={r['collective_s']:.3e}"
                     f" fits={rec['memory']['fits_hbm']}")
        elif rec["status"] == "error":
            line += " " + rec.get("error", "")[:140]
        elif rec["status"] == "skip":
            line += " " + rec.get("reason", "")[:100]
        print(line, flush=True)
        return rec

    ok = True
    if args.engine:
        for m in meshes:
            ok &= emit(run_engine_cell(mesh_kind=m))["status"] != "error"
    elif args.all:
        for arch, shape in all_cells():
            for m in meshes:
                ok &= emit(run_cell(arch, shape, m, remat=args.remat)
                           )["status"] != "error"
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all/--engine")
        for m in meshes:
            rec = emit(run_cell(args.arch, args.shape, m,
                                attn_stub=args.attn_stub, remat=args.remat))
            ok &= rec["status"] != "error"
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
