"""Mixture-of-Experts FFN with capacity-bounded index dispatch (the
reference's ``models/moe.py`` in torch).

Token->expert routing reuses the paper's Allocator discipline
(``core/dispatch.py``): items are ranked into fixed-capacity per-expert
buckets (first-come-first-served), overflow is dropped-and-counted, and
results are gathered back by (dest, rank). The expert products are plain
batched products over the expert axis, as the reference leaves them to
XLA. One device: the reference's expert-parallel ``moe_ffn_shard_map``
belongs with the sharding tools (ROADMAP.md), so ``moe_ffn`` is the
whole layer here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.dispatch import (bucket_mask, compute_ranks,
                                       gather_from_buckets,
                                       scatter_to_buckets)
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


def route(p, xt, cfg, capacity_factor: float):
    """Router and dispatch ranks for xt (T,d) -> (top_p (T,k) renormed
    gate weights, top_e (T,k) expert ids, rank (T*k,) each item's place
    in its expert's bucket, ok (T*k,) the items within capacity, cap,
    lb_loss)."""
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    probs = torch.softmax(xt.float() @ p["wg"].float(), dim=-1)   # (T, E)
    # lax.top_k's order: descending, ties to the lower expert id
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)

    # switch-style load-balance loss
    me = probs.mean(0)                                        # (E,)
    ce = F.one_hot(top_e[:, 0], E).float().mean(0)
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
    h1 = torch.bmm(buckets, p["w1"])                          # (E, cap, f)
    h3 = torch.bmm(buckets, p["w3"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    out_b = torch.bmm(a * h3, p["w2"])                        # (E, cap, d)
    out_b = torch.where(bmask[..., None], out_b, 0.0)

    # combine: weighted sum of each token's k expert outputs
    back = gather_from_buckets(out_b, dest, rank, ok, cap)    # (T*k, d)
    w = top_p.reshape(-1)[:, None].to(back.dtype)
    out = (back * w).reshape(T, k, d).sum(1)
    drop_frac = 1.0 - ok.float().mean()
    return out.reshape(B, S, d).to(x.dtype), {"lb_loss": lb_loss,
                                              "drop_frac": drop_frac}
