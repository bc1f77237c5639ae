"""Model assembly for every family (the reference's
``models/transformer.py`` in torch).

  dense   llama3/yi/gemma2/gemma3 (GQA, RoPE, sliding-window patterns,
          logit softcaps)
  vlm     the llava backbone (vision-stub embeddings over the prompt
          prefix)
  moe     mixtral/dbrx — dense attention + capacity-bounded MoE FFN
  ssm     mamba2 — attention-free SSD blocks
  hybrid  zamba2 — SSD backbone + one shared attention+MLP block applied
          every k-th layer (weight-tied, per-application KV cache)
  encdec  seamless — full-attention encoder (audio-stub input) + causal
          decoder with cross-attention

Three entry points, as in the reference:

  forward_hidden   full-sequence (training / scoring)    -> final hidden
  prefill          full-sequence + cache population      -> (last logits, cache)
  decode_step      one token against the cache           -> (logits, cache)

and the training loss, ``loss_fn`` (``chunked_xent`` over the final
hidden, never the whole (B,S,V) logits at once).

The parameters are one ``nn.Module`` tree (``models/params.py``): the
layers are an ``nn.ModuleList`` of blocks run in a Python loop — PyTorch
runs eagerly, so the reference's layer scan has no counterpart here. One
loop serves the three entry points: each passes the sequence operations
(self-attention, cross-attention, the SSD block) of its own kind. Under
grad, ``ModelOpts.remat="full"`` (the default, as the reference's) runs
each block under ``torch.utils.checkpoint``: its activations are
recomputed in the backward, only its input is kept. With
``scan_groups`` > 1 the remat has the reference's two levels (its
grouped layer scan): the blocks run in ``pick_groups(L, scan_groups)``
groups of consecutive blocks, each group under one checkpoint and each
block inside it under its own, so the backward keeps only the groups'
inputs and recomputes one group's block inputs at a time. The hybrid's
groups (``hybrid_layout``: e SSD layers and the shared block) are such
groups whatever ``scan_groups``, as the reference scans them.

``remat="dots"`` is the reference's ``jax.checkpoint(policy=
dots_with_no_batch_dims_saveable)`` at the same two levels: the same
non-reentrant checkpoints, made selective (torch's
``create_selective_checkpoint_contexts``, :func:`_dots_policy`). The
outputs of the products with no batch dimension are kept for the
backward (``MUST_SAVE``): the q/k/v/o projections (self- and
cross-attention, the encoder's), the MLP's w1 and w3, the MoE router's
logits, the SSD block's wz, wx, wB, wC and wdt. A block's last product
(the MLP's w2, the SSD's wo) is not kept: its output feeds only the
residual sum, so the reference's backward keeps it no more than full
does (``layers.dot``). Everything
else is recomputed (attention, the expert products, the SSD's chunked
einsums, norms, elementwise ops, collectives). The loss's chunks keep
their plain checkpoint. How the port answers what could go wrong:

  * Telling a batch-free product apart: not by the aten op or its shapes
    (``x @ w`` on a 3-D x lowers to ``mm``, ``torch.einsum`` of a
    projection to ``bmm`` with a batch of 1, an expert product to
    ``bmm`` with a batch of E, which can be 1 on a rank). Each such
    product is made through ``layers.dot``, which marks the ops it
    dispatches; the policy keeps the ``mm``/``addmm``/``bmm`` outputs
    made inside a mark (tests/test_torch_remat_dots.py holds what is
    kept to the reference's ``saved_residuals``).
  * Raw-pointer kernel launches: the flash forward and backward inside
    ``FlashAttentionFn`` are invisible to the policy's dispatch mode;
    their ``torch.empty`` outputs are recomputed like any op, so the
    recompute launches the forward again into fresh buffers, as under
    full (52 forward launches per gemma3-1b step either way).
  * Collectives: the counted collectives of ``train/parallel.py`` are
    recomputed (never kept: no mark), so a block's FSDP gathers run
    again in its recompute, and its in-place c10d ops are not cached.
  * Early stop: torch's checkpoint ends a recompute once the backward's
    saved tensors are all recomputed. The autograd nodes save the same
    tensors under dots (a kept product's output is returned from the
    cache where the recompute reaches it), so the stop falls at the same
    op and the collectives per step are those of full (the dry run
    counts them alike).
  * The dry run's meta tensors: the policy's dispatch modes stack above
    ``OpStream(track_memory=True)``, which sees the cache's tensors live
    (the plan's peak counts them) and no op of a cached product in the
    recompute (the plan's operations drop it).

On a training mesh (``par``: ``train/parallel.py`` ``MeshShard``; None
on one device) the training entry points (``loss_fn``,
``forward_hidden``, ``encode``) run one rank's share, in every family:
its rows of the batch and its cut of every leaf. Each block gathers its
FSDP shards inside its block function, so remat's recompute gathers
them again; the non-block leaves (zamba2's shared block among them) are
gathered once (``MeshShard.outer``). The collectives stand where the
reference's sharding constraints let GSPMD put them: the attention's
input and output where the heads split (Megatron's f and g: the
decoder's and the encoder's self-attention, the cross-attention's
queries and output, the shared block), the encoder's output once more
through f (the cross-attention's k and v read it on every rank, each
for its own heads), the MLP's and the MoE's where d_ff splits, the SSD
block's input and output where d_inner splits and its gated norm's
statistic (``models/ssm.py``), the embedding's sum over the vocab
shards, and the loss's max and sums over them (:func:`chunked_xent`);
the loss's sums and the MoE's statistics over the data shards.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as S
from repro_torch.models.layers import (embed, embed_shard, embed_spec,
                                       in_dot, mlp, mlp_spec, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.moe import moe_apply, moe_spec
from repro_torch.models.params import materialize
from repro_torch.utils import resolve_device

FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown model family "
                         f"{cfg.family!r}; known: {FAMILIES}")


REMAT = ("none", "full", "dots")


@dataclasses.dataclass(frozen=True)
class ModelOpts:
    """Static per-run model options."""

    remat: str = "full"          # none | full | dots: per-block checkpoint
    scan_groups: int = 1         # >1: two-level checkpoint (module doc)
    loss_chunk: int = 2048       # vocab-chunked xent sequence chunk
    act_dtype: torch.dtype = torch.float32  # residual-stream compute dtype
    attn_mode: str = "auto"      # flash op: auto | cuda | ref
    cap_factor: float = 1.25     # MoE dispatch capacity factor

    def __post_init__(self):
        if self.remat not in REMAT:
            raise ValueError(f"remat {self.remat!r} not in {REMAT}")
        if self.scan_groups < 1:
            raise ValueError(f"scan_groups={self.scan_groups} must be >= 1")


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------
def attn_mlp_block_spec(cfg: ArchConfig):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "attn": A.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


def moe_block_spec(cfg: ArchConfig):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "attn": A.attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model),
            "moe": moe_spec(cfg)}


def ssm_block_spec(cfg: ArchConfig):
    return {"ln1": rmsnorm_spec(cfg.d_model), "ssm": S.ssm_spec(cfg)}


def decoder_block_spec(cfg: ArchConfig):
    return {"ln1": rmsnorm_spec(cfg.d_model),
            "attn": A.attention_spec(cfg),
            "lnx": rmsnorm_spec(cfg.d_model),
            "xattn": A.cross_attention_spec(cfg),
            "ln2": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_spec(cfg.d_model, cfg.d_ff)}


_BLOCK_SPECS = {"dense": attn_mlp_block_spec, "vlm": attn_mlp_block_spec,
                "moe": moe_block_spec, "ssm": ssm_block_spec,
                "hybrid": ssm_block_spec, "encdec": decoder_block_spec}


def model_spec(cfg: ArchConfig):
    """The reference's spec tree with the layer axis unstacked: "blocks"
    (and the encoder's "enc_blocks") is a list of per-layer block specs
    (the same per-layer init scales); zamba2's "shared" block is one
    block, as in the reference."""
    check_family(cfg)
    d, L = cfg.d_model, cfg.num_layers
    out = {"tok": embed_spec(cfg.vocab_padded(), d, cfg.tie_embeddings),
           "fln": rmsnorm_spec(d),
           "blocks": [_BLOCK_SPECS[cfg.family](cfg) for _ in range(L)]}
    if cfg.family == "hybrid":
        out["shared"] = attn_mlp_block_spec(cfg)
    if cfg.family == "encdec":
        out["enc_blocks"] = [attn_mlp_block_spec(cfg)
                             for _ in range(cfg.enc_layers)]
        out["eln"] = rmsnorm_spec(d)
    return out


def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.float32) -> nn.Module:
    """Random-init parameters, drawn from ``gen`` on its device."""
    return materialize(model_spec(cfg), gen, dtype=dtype)


def pick_groups(L: int, want: int) -> int:
    """Largest divisor of L that is <= want (the grouped checkpoint's
    group count)."""
    g = max(1, min(want, L))
    while L % g:
        g -= 1
    return g


def hybrid_layout(cfg: ArchConfig):
    """(n_groups, group_len, tail_len): the zamba2 topology — the shared
    attention+MLP block runs after every ``hybrid_attn_every``-th SSM
    layer (application g after layer g·e + e − 1, with its own KV-cache
    row); trailing layers (L mod every) are pure SSM."""
    L, e = cfg.num_layers, cfg.hybrid_attn_every
    return L // e, e, L % e


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------
def _embed_inputs(params, cfg, tokens, opts, frontend_embeds, par=None):
    """Token embeddings; for decoder-only families ``frontend_embeds``
    (B,F,d) — patch embeddings or retrieved soft prompts — overwrite the
    first F prompt positions. For encdec they are the encoder's input
    and leave the token embeddings as they are."""
    if par is not None and par.vocab_split:
        x = par.vocab_sum(embed_shard(params["tok"], tokens, par.vocab_lo))
    else:
        x = embed(params["tok"], tokens)
    x = x.to(opts.act_dtype)
    if frontend_embeds is not None and cfg.family != "encdec":
        x = x.clone()
        F = frontend_embeds.shape[1]
        x[:, :F] = frontend_embeds.to(x.dtype)
    return x


def _positions(B: int, Sq: int, device):
    return torch.arange(Sq, dtype=torch.int32, device=device)[None].expand(
        B, Sq)


def _mlp(p, x, cfg, par=None):
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    if par is None:
        return x + mlp(p["mlp"], h, act=cfg.act)
    return x + par.ffn_out(mlp(p["mlp"], par.ffn_in(h), act=cfg.act))


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
             torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """remat "dots"' policy (the reference's
    ``dots_with_no_batch_dims_saveable``): keep the output of every
    product made by ``layers.dot``, recompute everything else."""
    if op in _PRODUCTS and in_dot():
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_contexts():
    return create_selective_checkpoint_contexts(_dots_policy)


def _remat(opts):
    """``run(fn, *xs)``: fn(*xs), under a non-reentrant checkpoint when
    grad is on and ``opts.remat`` is "full" or "dots" (the latter
    selective: :func:`_dots_policy`)."""
    if opts.remat == "none" or not torch.is_grad_enabled():
        return lambda fn, *xs: fn(*xs)
    if opts.remat == "dots":
        return lambda fn, *xs: checkpoint(fn, *xs, use_reentrant=False,
                                          context_fn=_dots_contexts)
    return lambda fn, *xs: checkpoint(fn, *xs, use_reentrant=False)


def _group(run, steps, tail=None):
    """One group's body: every step under its own ``run``, then
    ``tail`` (unwrapped) if given, over the carry tuple."""
    def body(*carry):
        for f in steps:
            carry = run(f, *carry)
        return tail(*carry) if tail is not None else carry
    return body


def scan_layers(steps, carry: tuple, opts, groups: int = 1) -> tuple:
    """Run ``steps`` (each ``f(*carry) -> carry``, one block) over the
    carry tuple: each under its own checkpoint, and with ``groups`` > 1
    in ``pick_groups(len(steps), groups)`` groups of consecutive steps,
    each group under one more (the module doc). Without remat (or
    grad) this is the plain loop."""
    run = _remat(opts)
    n = len(steps)
    g = pick_groups(n, groups) if n else 1
    if g == 1:
        return _group(run, steps)(*carry)
    per = n // g
    for j in range(g):
        carry = run(_group(run, steps[j * per:(j + 1) * per]), *carry)
    return carry


def _layers(params, cfg, x, opts, self_attn, cross, ssm, par=None):
    """The decoder stack of every family over x -> (x, aux). The three
    sequence operations each return x plus the layer's output:
    ``self_attn(p, x, j, window)`` (j: the layer's KV-cache slot),
    ``cross(p, x, i)`` (encdec) and ``ssm(p, x, i)``. aux holds the moe
    family's mean ``lb_loss`` and ``drop_frac`` over the layers. Each
    block (an SSD layer, a decoder layer) is one remat unit; the
    hybrid's groups and ``opts.scan_groups`` add the outer level. On a
    mesh each block gathers its shards first (``par.use``), inside its
    remat unit."""
    fam, eps = cfg.family, cfg.norm_eps

    def use(p):
        return p if par is None else par.use(p, "blocks")
    if fam in ("ssm", "hybrid"):
        blocks = params["blocks"]
        steps = [lambda x, p=p, i=i: (ssm(use(p), x, i),)
                 for i, p in enumerate(blocks)]
        if fam == "ssm":
            return scan_layers(steps, (x,), opts, opts.scan_groups)[0], {}
        G, e, _ = hybrid_layout(cfg)
        shared, run = params["shared"], _remat(opts)
        for j in range(G):
            # a group: e SSD layers, each its own remat unit, then the
            # shared block's application j, under one more
            x, = run(_group(run, steps[j * e:(j + 1) * e],
                            lambda x, j=j: (_mlp(shared, self_attn(
                                shared, x, j, cfg.window), cfg, par),)), x)
        return scan_layers(steps[G * e:], (x,), opts)[0], {}

    def block(p, i, win, x, lb=0.0, dr=0.0):
        p = use(p)
        x = self_attn(p, x, i, win)
        if fam == "encdec":
            x = cross(p, x, i)
        if fam != "moe":
            return (_mlp(p, x, cfg, par),)
        h, mx = moe_apply(p["moe"], rmsnorm(p["ln2"], x, eps), cfg,
                          capacity_factor=opts.cap_factor, act=cfg.act,
                          par=par)
        return x + h, lb + mx["lb_loss"], dr + mx["drop_frac"]

    carry = (x, 0.0, 0.0) if fam == "moe" else (x,)
    steps = [functools.partial(block, p, i, win)
             for i, (p, win) in enumerate(zip(params["blocks"],
                                              cfg.layer_windows()))]
    out = scan_layers(steps, carry, opts, opts.scan_groups)
    if fam != "moe":
        return out[0], {}
    x, lb, dr = out
    return x, {"lb_loss": lb / cfg.num_layers,
               "drop_frac": dr / cfg.num_layers}


def _tp_points(par):
    """(attn_in, attn_out, ssm_in, ssm_out) of a mesh's share (identities
    on one device)."""
    if par is None:
        return (lambda t: t,) * 4
    return par.attn_in, par.attn_out, par.ssm_in, par.ssm_out


def _full_sequence(params, cfg, tokens, opts, frontend_embeds, cache=None,
                   par=None):
    """The stack over the whole sequence (forward_hidden, prefill) ->
    (x, aux). With ``cache``, every layer's K/V, SSM and conv state and
    (encdec) cross K/V are written into it in place. ``params`` holds
    gathered non-block subtrees on a mesh (``MeshShard.outer``)."""
    check_family(cfg)
    B, Sq = tokens.shape
    eps = cfg.norm_eps
    x = _embed_inputs(params, cfg, tokens, opts, frontend_embeds, par)
    positions = _positions(B, Sq, tokens.device)
    attn_in, attn_out, ssm_in, ssm_out = _tp_points(par)
    enc = None
    if cfg.family == "encdec":
        if frontend_embeds is None:
            raise ValueError(f"{cfg.name}: encdec needs the encoder input "
                             f"(frontend_embeds)")
        # every rank's cross-attention reads it whole for its own heads
        enc = attn_in(_encode(params, cfg, frontend_embeds, opts, par))

    def put(name, j, t):
        if t.shape[1] > cache[name][j].shape[1]:
            raise ValueError(f"{name}: {t.shape[1]} rows do not fit the "
                             f"cache's {cache[name][j].shape[1]}")
        cache[name][j][:, :t.shape[1]] = t.to(cache[name][j].dtype)

    def self_attn(p, x, j, win):
        h = A.attention(p["attn"], attn_in(rmsnorm(p["ln1"], x, eps)), cfg,
                        window=win, positions=positions,
                        return_kv=cache is not None, mode=opts.attn_mode)
        if cache is not None:
            h, (k, v) = h
            put("k", j, k)
            put("v", j, v)
        return x + attn_out(h)

    def cross(p, x, i):
        k, v = A.encode_cross_kv(p["xattn"], enc)
        if cache is not None:
            # attend over what the cache holds, as the reference does
            put("xk", i, k)
            put("xv", i, v)
            Se = k.shape[1]
            k = cache["xk"][i][:, :Se].to(x.dtype)
            v = cache["xv"][i][:, :Se].to(x.dtype)
        return x + attn_out(A.cross_attention(
            p["xattn"], attn_in(rmsnorm(p["lnx"], x, eps)), (k, v), cfg,
            mode=opts.attn_mode))

    def ssm(p, x, i):
        h = S.ssm_chunked(p["ssm"], ssm_in(rmsnorm(p["ln1"], x, eps)), cfg,
                          return_state=cache is not None, par=par)
        if cache is not None:
            h, (st, cst) = h
            cache["ssm"][i] = st.to(cache["ssm"].dtype)
            cache["conv"][i] = cst.to(cache["conv"].dtype)
        return x + ssm_out(h)

    x, aux = _layers(params, cfg, x, opts, self_attn, cross, ssm, par)
    if cache is not None and enc is not None:
        cache["enc_len"].fill_(enc.shape[1])
    return x, aux


# ---------------------------------------------------------------------------
# forward_hidden / encode / logits
# ---------------------------------------------------------------------------
def forward_hidden(params, cfg: ArchConfig, tokens, *,
                   opts: ModelOpts = ModelOpts(), frontend_embeds=None,
                   par=None):
    """tokens (B,S) -> (hidden (B,S,d) final-normed, aux dict).

    frontend_embeds: decoder-only/vlm -> (B,F,d) embeddings (patch
    embeddings or retrieved soft prompts) overwriting the first F prompt
    positions; encdec -> (B,Se,d) encoder input (audio frames). ``par``:
    this rank's share on a training mesh (module doc)."""
    if par is not None:
        params = par.outer(params)
    return _forward_hidden(params, cfg, tokens, opts, frontend_embeds, par)


def _forward_hidden(params, cfg, tokens, opts, frontend_embeds, par):
    x, aux = _full_sequence(params, cfg, tokens, opts, frontend_embeds,
                            par=par)
    return rmsnorm(params["fln"], x, cfg.norm_eps), aux


def encode(params, cfg: ArchConfig, enc_input, *,
           opts: ModelOpts = ModelOpts(), par=None):
    """Encoder stack (encdec family). enc_input (B,Se,d) -> (B,Se,d):
    non-causal self-attention through the flash op, then the MLP."""
    if par is not None:
        params = par.outer(params)
    return _encode(params, cfg, enc_input, opts, par)


def _encode(params, cfg, enc_input, opts, par):
    B, Se, _ = enc_input.shape
    x = enc_input.to(opts.act_dtype)
    positions = _positions(B, Se, x.device)
    attn_in, attn_out, _, _ = _tp_points(par)

    def block(x, p):
        if par is not None:
            p = par.use(p, "enc_blocks")
        x = x + attn_out(A.attention(
            p["attn"], attn_in(rmsnorm(p["ln1"], x, cfg.norm_eps)), cfg,
            window=0, positions=positions, causal=False,
            mode=opts.attn_mode))
        return (_mlp(p, x, cfg, par),)

    x, = scan_layers([lambda x, p=p: block(x, p)
                      for p in params["enc_blocks"]], (x,), opts,
                     opts.scan_groups)
    return rmsnorm(params["eln"], x, cfg.norm_eps)


def logits_fn(params, cfg: ArchConfig, tokens, *,
              opts: ModelOpts = ModelOpts(), frontend_embeds=None):
    """Convenience full-logits path (tests / tiny configs only)."""
    h, aux = forward_hidden(params, cfg, tokens, opts=opts,
                            frontend_embeds=frontend_embeds)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[..., :cfg.vocab_size], aux


# ---------------------------------------------------------------------------
# Loss — vocab-chunked cross entropy (never materializes (B,S,V) at once)
# ---------------------------------------------------------------------------
def _xent_sums(tok_params, hidden, labels, *, tie: bool, softcap: float,
               chunk: int, par=None):
    """(summed token losses, tokens counted, tokens predicted right) of
    :func:`chunked_xent`, this rank's rows on a mesh. With the vocab
    split over "model" a chunk's logits are this rank's (B,C,V/m) slice:
    the row max and the sums of exp and of the label's logit are
    all-reduced over "model" (the label's logit counts as right when it
    is the row's max: argmax but for an exact tie)."""
    B, Sq, d = hidden.shape
    C = min(chunk, Sq)
    pad = (-Sq) % C
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)

    def body(h_c, y_c, tok):
        logits = unembed(tok, h_c, tie, softcap)           # (B,C,V) f32
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, y_c.clamp_min(0)[..., None].long())[..., 0]
        mask = (y_c >= 0).float()
        correct = (logits.argmax(-1) == y_c).float() * mask
        return ((lse - ll) * mask).sum(), mask.sum(), correct.sum()

    def body_vocab_split(h_c, y_c, tok):
        logits = unembed(tok, par.vocab_in(h_c), tie, softcap)
        rows = logits.shape[-1]
        m = par.vocab_max(logits.amax(-1))
        local = y_c.long() - par.vocab_lo
        hit = ((local >= 0) & (local < rows)).float()
        ll = logits.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
        s, ll = par.vocab_sum(torch.stack(
            [torch.exp(logits - m[..., None]).sum(-1), ll * hit],
            -1)).unbind(-1)
        lse = m + torch.log(s)
        mask = (y_c >= 0).float()
        correct = (ll >= m).float() * mask
        return ((lse - ll) * mask).sum(), mask.sum(), correct.sum()

    fn = body_vocab_split if par is not None and par.vocab_split else body
    tot = cnt = ncorrect = 0.0
    for c in range((Sq + pad) // C):
        sl = slice(c * C, (c + 1) * C)
        t, n, k = checkpoint(fn, hidden[:, sl], labels[:, sl], tok_params,
                             use_reentrant=False)
        tot, cnt, ncorrect = tot + t, cnt + n, ncorrect + k
    return tot, torch.as_tensor(cnt, device=hidden.device), ncorrect


def chunked_xent(tok_params, hidden, labels, *, tie: bool, softcap: float,
                 chunk: int, par=None):
    """hidden (B,S,d) final-normed, labels (B,S) int (-1 = ignore) ->
    (mean loss, {"tokens", "accuracy"}). Each chunk of ``chunk``
    positions runs under a checkpoint, so no chunk's (B,C,V) logits are
    kept for the backward: it recomputes them. On a mesh (``par``) the
    mean is over every data shard's tokens: the three sums are
    all-reduced over the data axes."""
    tot, cnt, ncorrect = _xent_sums(tok_params, hidden, labels, tie=tie,
                                    softcap=softcap, chunk=chunk, par=par)
    if par is not None and par.mesh.size("fsdp") > 1:
        tot, cnt, ncorrect = par.reduce_data(torch.stack(
            [tot, cnt, torch.as_tensor(ncorrect)])).unbind()
    cnt = torch.clamp(cnt, min=1.0)
    return tot / cnt, {"tokens": cnt, "accuracy": ncorrect / cnt}


def loss_fn(params, cfg: ArchConfig, batch, *, opts: ModelOpts = ModelOpts(),
            lb_coef: float = 0.01, par=None):
    """batch: tokens (B,S), labels (B,S), optional frontend (B,F,d) ->
    (loss, metrics): the chunked cross entropy ("xent"), plus lb_coef x
    the moe family's load-balance loss. On a mesh (``par``) the batch is
    this rank's rows and the loss the whole batch's; a shard-map MoE's
    ``lb_loss`` and ``drop_frac`` are the data shards' mean."""
    if par is not None:
        params = par.outer(params)
    hidden, aux = _forward_hidden(params, cfg, batch["tokens"], opts,
                                  batch.get("frontend"), par)
    loss, metrics = chunked_xent(
        params["tok"], hidden, batch["labels"], tie=cfg.tie_embeddings,
        softcap=cfg.softcap_final, chunk=opts.loss_chunk, par=par)
    metrics["xent"] = loss
    if "lb_loss" in aux:
        lb, drop = aux["lb_loss"], aux["drop_frac"]
        n = 1 if par is None else par.mesh.size("fsdp")
        if par is not None and par.moe_shard_map and n > 1:
            lb, drop = (par.reduce_data(torch.stack([lb, drop]))
                        / n).unbind()
        loss = loss + lb_coef * lb
        metrics["lb_loss"] = lb
        metrics["drop_frac"] = drop
    metrics["loss"] = loss
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode caches
# ---------------------------------------------------------------------------
def cache_spec(cfg: ArchConfig, batch: int, cache_len: int, *,
               enc_len: int = 0):
    """Shapes of the decode cache: the next position; per-layer (B,
    cache_len, K, hd) k and v (per shared-block application for the
    hybrid); the stacked (L, ...) SSM and conv states (ssm, hybrid); the
    per-layer (B, enc_len, K, hd) cross k and v and the encoder length
    (encdec)."""
    check_family(cfg)
    fam, L = cfg.family, cfg.num_layers

    def kv(n, length):
        return [(batch, length, cfg.num_kv_heads, cfg.head_dim)] * n

    out = {"pos": ()}
    if fam in ("dense", "vlm", "moe", "encdec"):
        out["k"] = out["v"] = kv(L, cache_len)
    if fam in ("ssm", "hybrid"):
        ssm, conv = S.state_shapes(cfg, batch)
        out["ssm"], out["conv"] = (L, *ssm), (L, *conv)
    if fam == "hybrid":
        out["k"] = out["v"] = kv(hybrid_layout(cfg)[0], cache_len)
    if fam == "encdec":
        out["xk"] = out["xv"] = kv(L, enc_len)
        out["enc_len"] = ()
    return out


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               enc_len: int = 0, dtype=torch.bfloat16, device="cuda"):
    """Zeroed cache on ``device``. The k/v (and cross xk/xv) caches are
    LISTS of per-layer tensors that prefill and decode_step update in
    place (the reference keeps a list of per-layer leaves for the same
    reason: one buffer per layer is written where it lies, never
    copied). The SSM and conv states are f32 whatever ``dtype``, as the
    reference's; ``pos`` and ``enc_len`` are 0-d int32 tensors on
    ``device``, as the reference's device scalars: prefill and
    decode_step write them in place, so a captured decode step reads
    the position where it lies and never on the host."""
    device = resolve_device(device)
    out = {}
    for name, shape in cache_spec(cfg, batch, cache_len,
                                  enc_len=enc_len).items():
        if name in ("pos", "enc_len"):
            out[name] = torch.zeros((), dtype=torch.int32, device=device)
        elif name in ("ssm", "conv"):
            out[name] = torch.zeros(shape, dtype=torch.float32, device=device)
        else:
            out[name] = [torch.zeros(s, dtype=dtype, device=device)
                         for s in shape]
    return out


# ---------------------------------------------------------------------------
# Prefill — full-sequence forward that also populates the cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def prefill(params, cfg: ArchConfig, tokens, cache, *,
            opts: ModelOpts = ModelOpts(), frontend_embeds=None):
    """tokens (B,S) with S <= cache_len. Returns (last logits (B,V),
    cache); the cache's tensors are written in place (encdec: the cross
    K/V of the Se encoder frames, Se <= the cache's enc_len).

    All prompts in the batch share length S (positions are absolute)."""
    cache = dict(cache)
    x, _ = _full_sequence(params, cfg, tokens, opts, frontend_embeds,
                          cache=cache)
    cache["pos"].fill_(tokens.shape[1])
    h = rmsnorm(params["fln"], x[:, -1:], cfg.norm_eps)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[:, 0, :cfg.vocab_size], cache


# ---------------------------------------------------------------------------
# Decode — one token against the cache
# ---------------------------------------------------------------------------
@torch.no_grad()
def decode_step(params, cfg: ArchConfig, cache, tokens, *,
                opts: ModelOpts = ModelOpts()):
    """tokens (B,1) -> (logits (B,V), cache). pos = cache['pos'], a 0-d
    device tensor that the step advances in place; each attention layer
    writes only its new (B,1,K,hd) slot, in place, and attends over the
    same tensor; each SSD layer steps its state in place;
    cross-attention reads the encoder cache's first enc_len rows. Every
    attention here is the plain one-row path. Nothing reads a device
    value on the host, so the step can be captured once and replayed
    (launch/serve.py ``make_step_fns``)."""
    check_family(cfg)
    pos, eps = cache["pos"], cfg.norm_eps
    x = embed(params["tok"], tokens).to(opts.act_dtype)
    cache = dict(cache)
    # the new K/V row, as the reference's dynamic_update_slice places it:
    # the index clamped so the one-row update fits
    row = (pos.clamp(0, cache["k"][0].shape[1] - 1).long().view(1)
           if "k" in cache else None)

    def self_attn(p, x, j, win):
        q, k, v = A.decode_qkv(p["attn"], rmsnorm(p["ln1"], x, eps), pos,
                               cfg)
        ck, cv = cache["k"][j], cache["v"][j]
        ck.index_copy_(1, row, k.to(ck.dtype))
        cv.index_copy_(1, row, v.to(cv.dtype))
        return x + A.decode_attend(p["attn"], q, ck, cv, cfg, window=win,
                                   pos=pos)

    def cross(p, x, i):
        return x + A.cross_attention(p["xattn"], rmsnorm(p["lnx"], x, eps),
                                     (cache["xk"][i], cache["xv"][i]), cfg,
                                     enc_valid=cache["enc_len"], decode=True)

    def ssm(p, x, i):
        h, (st, cst) = S.ssm_step(p["ssm"], rmsnorm(p["ln1"], x, eps),
                                  (cache["ssm"][i], cache["conv"][i]), cfg)
        cache["ssm"][i] = st
        cache["conv"][i] = cst
        return x + h

    x, _ = _layers(params, cfg, x, opts, self_attn, cross, ssm)
    pos.add_(1)
    h = rmsnorm(params["fln"], x, cfg.norm_eps)
    logits = unembed(params["tok"], h, cfg.tie_embeddings, cfg.softcap_final)
    return logits[:, 0, :cfg.vocab_size], cache
