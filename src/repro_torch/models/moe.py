"""Mixture-of-Experts FFN with capacity-bounded index dispatch (the
reference's ``models/moe.py`` in torch).

Token->expert routing reuses the paper's Allocator discipline
(``core/dispatch.py``): items are ranked into fixed-capacity per-expert
buckets (first-come-first-served), overflow is dropped-and-counted, and
results are gathered back by (dest, rank). The expert products are plain
batched products over the expert axis, as the reference leaves them to
XLA.

On a training mesh (``train/parallel.py`` ``MeshShard``, one process per
rank holding its rows of the batch) :func:`moe_apply` picks one of two
meanings by the reference's rule (``src/repro/models/moe.py:159``):

  * :func:`moe_ffn_shard_map` where the model axis has more than one
    rank and splits d_ff: each data shard dispatches its own rows
    (capacity from the local token count, first-come-first-served ranks
    local), the expert FFNs are tensor-parallel on d_ff, one all-reduce
    over "model" combines them, and ``lb_loss`` / ``drop_frac`` are
    the data shards' mean (taken once per step by ``loss_fn``).
  * otherwise :func:`moe_ffn_global`: the one-device layer's meaning
    over the whole batch. An item is dropped by its global rank (its
    local rank plus the items of its expert on lower data ranks, from
    an all-gather of the (E,) counts), the capacity comes from the
    global token count and ``lb_loss`` from all-reduced router means;
    the expert products stay local (a row's output depends on that row
    alone).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dispatch import (bucket_mask, compute_ranks,
                                       gather_from_buckets,
                                       scatter_to_buckets)
from repro_torch.models.layers import dot
from repro_torch.models.params import spec
from repro_torch.utils import round_up


def moe_spec(cfg):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    return {
        "wg": spec((d, E), ("embed", None)),
        "w1": spec((E, d, f), ("experts", "embed", "ffn")),
        "w3": spec((E, d, f), ("experts", "embed", "ffn")),
        "w2": spec((E, f, d), ("experts", "ffn", "embed")),
    }


def capacity(tokens: int, cfg, capacity_factor: float) -> int:
    """Slots per expert bucket, as the reference sizes them."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    return int(round_up(max(int(tokens * k / E * capacity_factor), 4), 4))


def gate(p, xt, cfg):
    """The router on xt (T,d) -> (probs (T,E), top_p (T,k) renormed gate
    weights, top_e (T,k) expert ids)."""
    k = cfg.num_experts_per_tok
    probs = torch.softmax(dot(xt.float(), p["wg"].float()), dim=-1)   # (T, E)
    # lax.top_k's order: descending, ties to the lower expert id
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    return probs, top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9), top_e


def top1_onehot(top_e, E: int):
    """(T, E) f32: each token's first expert as a one-hot row. A
    comparison, not ``F.one_hot``, which checks its indices' range with
    a read of the device on the host (a captured decode step has none)."""
    experts = torch.arange(E, dtype=top_e.dtype, device=top_e.device)
    return (top_e[:, :1] == experts).float()


def route(p, xt, cfg, capacity_factor: float):
    """Router and dispatch ranks for xt (T,d) -> (top_p (T,k) renormed
    gate weights, top_e (T,k) expert ids, rank (T*k,) each item's place
    in its expert's bucket, ok (T*k,) the items within capacity, cap,
    lb_loss)."""
    E = cfg.num_experts
    probs, top_p, top_e = gate(p, xt, cfg)

    # switch-style load-balance loss
    me = probs.mean(0)                                        # (E,)
    ce = top1_onehot(top_e, E).mean(0)
    lb_loss = E * (me * ce).sum()

    # capacity-bounded dispatch (Allocator discipline)
    cap = capacity(xt.shape[0], cfg, capacity_factor)
    dest = top_e.reshape(-1)                                  # (T*k,)
    rank, _ = compute_ranks(dest, torch.ones_like(dest, dtype=torch.bool),
                            E)
    return top_p, top_e, rank, rank < cap, cap, lb_loss


def moe_ffn(p, x, cfg, *, capacity_factor: float = 1.25,
            act: str = "silu"):
    """x (B,S,d) -> (out (B,S,d), aux dict with the load-balance loss
    ``lb_loss`` and the dropped share of (token, expert) items
    ``drop_frac``, both 0-d f32 tensors)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    top_p, top_e, rank, ok, cap, lb_loss = route(p, xt, cfg,
                                                 capacity_factor)
    dest = top_e.reshape(-1)
    payload = xt.repeat_interleave(k, dim=0)                  # (T*k, d)
    buckets = scatter_to_buckets(dest, rank, ok, payload, E, cap)
    bmask = bucket_mask(dest, rank, ok, E, cap)

    # expert computation: the gated MLP batched over the expert axis
    out_b = torch.where(bmask[..., None], _experts(p, buckets, act), 0.0)

    # combine: weighted sum of each token's k expert outputs
    back = gather_from_buckets(out_b, dest, rank, ok, cap)    # (T*k, d)
    w = top_p.reshape(-1)[:, None].to(back.dtype)
    out = (back * w).reshape(T, k, d).sum(1)
    drop_frac = 1.0 - ok.float().mean()
    return out.reshape(B, S, d).to(x.dtype), {"lb_loss": lb_loss,
                                              "drop_frac": drop_frac}


def _experts(p, buckets, act):
    """The gated MLP batched over the expert axis: (E, C, d) -> (E, C, d)."""
    h1 = torch.bmm(buckets, p["w1"])                          # (E, cap, f)
    h3 = torch.bmm(buckets, p["w3"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    return torch.bmm(a * h3, p["w2"])                         # (E, cap, d)


def moe_ffn_shard_map(p, x, cfg, *, par, capacity_factor: float = 1.25,
                      act: str = "silu"):
    """The reference's ``moe_ffn_shard_map`` on one rank: x (B_local, S,
    d), this rank's rows, replicated over "model"; w1/w3 (E, d, f/m) and
    w2 (E, f/m, d) its d_ff slice. Returns (out (B_local, S, d), aux)
    with this data shard's ``lb_loss`` and ``drop_frac`` (``loss_fn``
    takes their mean over the data axes). Collectives: the output's
    all-reduce over "model" (forward), and in the backward the expert
    input's and the gate weights' all-reduces (Megatron's f: every
    model rank holds a partial product of each routed row)."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    xt = x.reshape(T, d)
    top_p, top_e, rank, ok, cap, lb_loss = route(p, xt, cfg,
                                                 capacity_factor)
    dest = top_e.reshape(-1)
    payload = par.ffn_in(xt).repeat_interleave(k, dim=0)
    buckets = scatter_to_buckets(dest, rank, ok, payload, E, cap)
    bmask = bucket_mask(dest, rank, ok, E, cap)
    out_b = torch.where(bmask[..., None], _experts(p, buckets, act), 0.0)
    back = gather_from_buckets(out_b, dest, rank, ok, cap)    # partial
    w = par.ffn_in(top_p.reshape(-1)[:, None].to(back.dtype))
    out = par.ffn_out((back * w).reshape(T, k, d).sum(1))
    drop_frac = 1.0 - ok.float().mean()
    return out.reshape(B, S, d).to(x.dtype), {"lb_loss": lb_loss,
                                              "drop_frac": drop_frac}


def moe_ffn_global(p, x, cfg, *, par, capacity_factor: float = 1.25,
                   act: str = "silu"):
    """The one-device layer's meaning over the rows of every data shard
    (module doc). x (B_local, S, d): this rank's rows, the data shards'
    rows contiguous in rank order. The (E,) counts' all-gather and the
    router statistics' all-reduce run over the FSDP axes."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    T = B * S
    n = par.mesh.size("fsdp")
    xt = x.reshape(T, d)
    probs, top_p, top_e = gate(p, xt, cfg)
    stats = torch.cat([probs.sum(0), top1_onehot(top_e, E).sum(0)])
    stats = par.reduce_data(stats) / (T * n)
    lb_loss = E * (stats[:E] * stats[E:]).sum()

    cap = capacity(T * n, cfg, capacity_factor)
    dest = top_e.reshape(-1)
    rank, counts = compute_ranks(
        dest, torch.ones_like(dest, dtype=torch.bool), E)
    every = par.gather_data(counts[None])                     # (n, E)
    below = every[:par.mesh.coord("fsdp")].sum(0)
    ok = rank + below[dest] < cap
    cap_local = min(cap, T * k)     # ok items have local rank < both
    payload = xt.repeat_interleave(k, dim=0)
    buckets = scatter_to_buckets(dest, rank, ok, payload, E, cap_local)
    bmask = bucket_mask(dest, rank, ok, E, cap_local)
    out_b = torch.where(bmask[..., None], _experts(p, buckets, act), 0.0)
    back = gather_from_buckets(out_b, dest, rank, ok, cap_local)
    w = top_p.reshape(-1)[:, None].to(back.dtype)
    out = (back * w).reshape(T, k, d).sum(1)
    kept = par.reduce_data(ok.float().sum()[None])[0]
    drop_frac = 1.0 - kept / (T * n * k)
    return out.reshape(B, S, d).to(x.dtype), {"lb_loss": lb_loss,
                                              "drop_frac": drop_frac}


def moe_apply(p, x, cfg, *, capacity_factor: float = 1.25,
              act: str = "silu", par=None):
    """The reference's selection (``src/repro/models/moe.py:159-179``):
    the shard-map layer where the mesh's model axis has more than one
    rank and the rules split d_ff over it; else the layer's global
    meaning (``moe_ffn`` itself on one data shard)."""
    kw = dict(capacity_factor=capacity_factor, act=act)
    if par is None:
        return moe_ffn(p, x, cfg, **kw)
    if par.moe_shard_map:
        return moe_ffn_shard_map(p, x, cfg, par=par, **kw)
    if par.mesh.size("fsdp") > 1:
        return moe_ffn_global(p, x, cfg, par=par, **kw)
    return moe_ffn(p, x, cfg, **kw)
