"""Sharding rules: logical axis names -> mesh axes, per (arch, step kind)
(the reference's ``models/sharding.py``, table for table).

Two tables per rule set (the same logical name can legally map differently
for a parameter and an activation — e.g. "embed" is FSDP-sharded on params
but unsharded on the residual stream, whose batch axis already occupies
the data mesh axis):

  * params — read by ``params.param_pspecs``. FSDP: every major param
    matrix carries one axis sharded over the data (+pod) axes, gathered
    at use, its grads reduce-scattered (ZeRO-3).
  * acts   — the activations' specs. TP: heads/ffn/experts live on the
    "model" axis.

``MeshRules`` duck-types ``ShardingRules`` (``.lookup`` == activation
lookup). Axes are only mapped when the dimension is divisible by the mesh
axis size; otherwise the dim stays replicated (kv_heads=8 on a 16-way
model axis).

A mesh is anything with ``axis_names`` and a size per axis
(``launch/mesh.py``: :func:`~repro_torch.launch.mesh.axis_sizes`): the
planning meshes of ``make_production_mesh``, a ``DeviceMesh`` of
``torch.distributed``, or the reference tests' stand-ins. Nothing here
opens a process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.params import ShardingRules, spec_leaves


@dataclasses.dataclass(frozen=True)
class MeshRules:
    acts: ShardingRules
    params: ShardingRules
    mesh: object = None

    def lookup(self, name):                 # duck-type ShardingRules
        return self.acts.lookup(name)


def _prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def make_rules(cfg: ArchConfig, mesh, *, kind: str = "train",
               force_fsdp_params: Optional[bool] = None) -> MeshRules:
    """Build FSDP+TP rules for ``cfg`` on ``mesh``.

    kind: train | prefill | decode | decode_long
    """
    sizes = axis_sizes(mesh)
    names = tuple(sizes)
    has_pod = "pod" in names
    fsdp = ("pod", "data") if has_pod else ("data",)
    fsdp_size = _prod(sizes.get(a, 1) for a in fsdp)
    model = "model" if "model" in names else None
    msize = sizes.get("model", 1)

    def div(n: int, axis, size: int):
        return axis if (axis and n and n % size == 0) else None

    vpad = cfg.vocab_padded()

    # ---- parameter table --------------------------------------------------
    # Serving keeps TP but drops FSDP when the whole model fits one chip's
    # share under TP alone (gathering weights every decode step is pure
    # overhead there); training always uses FSDP. The TP-only bytes are
    # exact per leaf: dims that don't divide the model axis replicate.
    if force_fsdp_params is None:
        fsdp_params = (kind == "train"
                       or _tp_only_bytes(cfg, msize) > 6e9)
    else:
        fsdp_params = force_fsdp_params
    p_embed = (fsdp if (fsdp_params and cfg.d_model % fsdp_size == 0)
               else None)

    # MoE: experts stay unsharded on the expert axis; expert FFNs are TP
    # over "model" on d_ff and the dispatch is local per data shard.
    p_experts = None
    p_ffn = div(cfg.d_ff, model, msize)

    param_table = {
        "embed": p_embed,
        "ffn": p_ffn,
        "heads": div(cfg.num_heads, model, msize),
        "kv_heads": div(cfg.num_kv_heads, model, msize),
        "head_dim": None,
        "vocab": div(vpad, model, msize),
        "experts": p_experts,
        "ssm_inner": div(cfg.d_inner, model, msize),
        "ssm_heads": div(cfg.ssm_heads, model, msize),
        "layers": None,
    }

    # ---- activation table --------------------------------------------------
    # KV cache for decode: kv_heads on the model axis; when the kv-head
    # count doesn't divide it, shard head_dim instead (partial sums and
    # an all-reduce beat replicating a multi-GB cache per chip).
    kv_axis = div(cfg.num_kv_heads, model, msize)
    hd_axis = None if kv_axis else div(cfg.head_dim, model, msize)
    if kind == "decode_long":
        # batch == 1: shard the KV cache along sequence over every axis;
        # per-token compute is trivial -> replicate it.
        seq_axes = (("pod",) if has_pod else ()) + ("data", "model")
        act_table = {
            "batch": None, "seq": seq_axes, "embed": None, "ffn": None,
            "heads": None, "kv_heads": None, "head_dim": None,
            "cache_hd": None, "vocab": None, "experts": None,
            "moe_cap": None,
            "ssm_inner": div(cfg.d_inner, model, msize),
            "ssm_heads": div(cfg.ssm_heads, model, msize),
            "layers": None,
        }
    else:
        act_table = {
            "batch": fsdp,
            "seq": None,
            "embed": None,
            "ffn": p_ffn,
            # decode with hd-sharded caches: q/k/v shard head_dim, so
            # heads stay unsharded (one mesh axis per spec)
            "heads": (None if (kind == "decode" and hd_axis)
                      else div(cfg.num_heads, model, msize)),
            "kv_heads": kv_axis if kind != "train"
            else div(cfg.num_kv_heads, model, msize),
            # decode attends over the sharded cache, so the new token's
            # q/k/v shard head_dim to match; prefill does not. "cache_hd"
            # shards the cache's storage only.
            "head_dim": hd_axis if kind == "decode" else None,
            "cache_hd": hd_axis if kind in ("decode", "prefill") else None,
            "vocab": div(vpad, model, msize),
            "experts": p_experts,
            "moe_cap": fsdp,
            "ssm_inner": div(cfg.d_inner, model, msize),
            "ssm_heads": div(cfg.ssm_heads, model, msize),
            "layers": None,
        }
    return MeshRules(acts=ShardingRules.of(act_table),
                     params=ShardingRules.of(param_table), mesh=mesh)


def cache_pspec_names(kind: str):
    """Logical names for KV-cache arrays (layers, batch, seq, kv, hd)."""
    return ("layers", "batch", "seq", "kv_heads", "head_dim")


def _tp_only_bytes(cfg: ArchConfig, msize: int) -> float:
    """Exact per-chip bf16 param bytes under TP-only sharding (a walk of
    the port's per-layer spec tree: the reference's stacked walk's
    total, every term an integer)."""
    from repro_torch.models.transformer import model_spec  # lazy: cycle

    shardable = {"ffn": cfg.d_ff, "heads": cfg.num_heads,
                 "kv_heads": cfg.num_kv_heads, "vocab": cfg.vocab_padded(),
                 "ssm_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads}
    total = 0.0
    for s in spec_leaves(model_spec(cfg)):
        n = 1.0
        for dim, name in zip(s.shape, s.names):
            if (name in shardable and shardable[name]
                    and shardable[name] % msize == 0):
                n *= dim / msize
            else:
                n *= dim
        total += n * 2.0
    return total
