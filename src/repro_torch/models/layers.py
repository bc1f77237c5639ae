"""Shared layers: RMSNorm, gated MLP, embedding/head (the reference's
``models/layers.py`` in torch). The reference's sharding constraints
have no twin: on a training mesh the model code adds the collectives
itself (``train/parallel.py``), and :func:`embed_shard` is one vocab
shard's part of the lookup.

:func:`dot` is how the model makes a product with no batch dimension
(a projection by a weight) whose output the backward reads: remat
"dots" (``models/transformer.py``) keeps the outputs of these products
and recomputes the rest, as the reference's
``dots_with_no_batch_dims_saveable`` keeps its batch-free
``dot_general``s. A block's last product (the MLP's w2, the SSD's wo)
feeds only the residual sum, whose backward reads neither operand: the
reference's backward keeps no such output, and it is made unmarked."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.params import spec

# >0 while a dot() runs (read by remat "dots"' policy)
_IN_DOT = 0


def dot(x, w, eq: str | None = None):
    """``x @ w`` (or ``torch.einsum(eq, x, w)``) for a product with no
    batch dimension: the weight is shared by every row of x. Marked so
    that remat "dots" can tell it from the batched products (attention,
    the experts), which lower to the same aten ops."""
    global _IN_DOT
    _IN_DOT += 1
    try:
        return x @ w if eq is None else torch.einsum(eq, x, w)
    finally:
        _IN_DOT -= 1


def in_dot() -> bool:
    """Whether the op being dispatched belongs to a :func:`dot`."""
    return _IN_DOT > 0


def rmsnorm_spec(d: int):
    return {"scale": spec((d,), ("embed",), init="ones")}


def rmsnorm(p, x, eps: float = 1e-6, *, sum_sq=None, width: int = 0):
    """RMSnorm over the last dim. Where x is one slice of the normed
    vector (a cut of it over ranks), ``sum_sq`` maps the slice's sum of
    squares to the whole vector's and ``width`` is the whole width."""
    xf = x.float()
    if sum_sq is None:
        var = (xf * xf).mean(-1, keepdim=True)
    else:
        var = sum_sq((xf * xf).sum(-1, keepdim=True)) / width
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def mlp_spec(d: int, f: int):
    """Gated MLP (llama-style): silu(x W1) * (x W3) @ W2."""
    return {
        "w1": spec((d, f), ("embed", "ffn")),
        "w3": spec((d, f), ("embed", "ffn")),
        "w2": spec((f, d), ("ffn", "embed")),
    }


def mlp(p, x, act: str = "silu"):
    h1 = dot(x, p["w1"])
    h3 = dot(x, p["w3"])
    # jax.nn.gelu defaults to the tanh approximation
    a = F.silu(h1) if act == "silu" else F.gelu(h1, approximate="tanh")
    return (a * h3) @ p["w2"]          # the block's last product: unmarked


def embed_spec(vocab: int, d: int, tie: bool):
    out = {"embedding": spec((vocab, d), ("vocab", "embed"), scale=1.0)}
    if not tie:
        out["head"] = spec((d, vocab), ("embed", "vocab"))
    return out


def embed(p, tokens):
    return p["embedding"][tokens]


def embed_shard(p, tokens, lo: int):
    """One shard of a vocab-parallel lookup: the embedding holds rows
    [lo, lo + rows); each token reads its row where it falls there and
    zeros elsewhere, so the shards' sum is :func:`embed`."""
    emb = p["embedding"]
    rows = emb.shape[0]
    local = tokens.long() - lo
    hit = (local >= 0) & (local < rows)
    return emb[local.clamp(0, rows - 1)] * hit[..., None].to(emb.dtype)


def unembed(p, x, tie: bool, softcap: float = 0.0):
    logits = x @ (p["embedding"].T if tie else p["head"])
    logits = logits.float()
    if softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
