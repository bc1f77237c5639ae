"""Collectives of the sharded training step, differentiable where the
step differentiates through them, and counted.

Every tensor collective of the step goes through :func:`collective`,
which skips an axis of one rank (nothing launches), runs the
``torch.distributed`` call on the axis's group (``launch/mesh.py``
``TrainMesh``) and adds one call and the tensor's bytes to
:data:`STATS` under its kind ("all-gather", "reduce-scatter",
"all-reduce"), axis and tag. The bytes are the collective's logical
tensor: the gathered output of an all-gather, the input of a
reduce-scatter, the reduced tensor of an all-reduce; ``_Wire``'s ring
formulas (``launch/dryrun.py``) turn them into wire bytes. Tag
``"step"`` is what the dry run models; ``"scalar"`` marks the
reductions of the loss, the norm, the NaN guard and the MoE's
statistics, ``"factored"`` the factored second moment's row and column
means, ``"checkpoint"`` the gathers of a save, all listed apart.

The autograd pairs (the objective is one number, replicated on every
rank of an axis, and each rank's gradient holds its own shard):

  all_gather    forward all-gather; backward reduce-scatter (sum): FSDP.
  all_reduce    forward all-reduce (sum); backward identity: Megatron's
                g, after a row-parallel product, and the sums of the
                loss over the batch's data shards.
  copy_to       forward identity; backward all-reduce (sum): Megatron's
                f, before a column-parallel product.
  all_reduce_both
                forward all-reduce (sum); backward all-reduce (sum): a
                statistic every rank computes from its own slice and
                every rank then uses, each through its own slice (the
                SSD's gated norm over a cut d_inner), so each rank's
                cotangent is a part of the whole one.
"""
from __future__ import annotations

import collections
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass
class CollectiveStats:
    """Calls and logical bytes by (kind, axis, ranks, tag)."""

    calls: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)
    nbytes: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)

    def add(self, kind: str, axis: str, ranks: int, nbytes: int,
            tag: str) -> None:
        key = (kind, axis, ranks, tag)
        self.calls[key] += 1
        self.nbytes[key] += int(nbytes)

    def reset(self) -> None:
        self.calls.clear()
        self.nbytes.clear()

    def rows(self, tag: str | None = None) -> list:
        """[(kind, axis, ranks, bytes, calls)] (one tag, or all)."""
        return [(k[0], k[1], k[2], self.nbytes[k], c)
                for k, c in sorted(self.calls.items())
                if tag is None or k[3] == tag]


#: the counts of every collective this process ran through :func:`collective`
STATS = CollectiveStats()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def collective(kind: str, x: torch.Tensor, mesh, axis, *, dim: int = 0,
               op: str = "sum", tag: str = "step") -> torch.Tensor:
    """One collective over ``axis`` of ``mesh`` (no grad): "all-gather"
    concatenates the ranks' ``x`` along ``dim``, "reduce-scatter" sums
    and keeps this rank's slice of ``dim``, "all-reduce" reduces with
    ``op``. An axis of one rank returns ``x`` and launches nothing."""
    n = mesh.size(axis)
    if n == 1:
        return x
    group = mesh.group(axis)
    if kind == "all-gather":
        xs = x.movedim(dim, 0).contiguous()
        out = xs.new_empty((n * xs.shape[0],) + tuple(xs.shape[1:]))
        dist.all_gather_into_tensor(out, xs, group=group)
        STATS.add(kind, mesh.key(axis), n,
                  out.numel() * out.element_size(), tag)
        return out.movedim(0, dim)
    if kind == "reduce-scatter":
        xs = x.movedim(dim, 0).contiguous()
        if xs.shape[0] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                             f"split over {n} ranks")
        out = xs.new_empty((xs.shape[0] // n,) + tuple(xs.shape[1:]))
        dist.reduce_scatter_tensor(out, xs, op=dist.ReduceOp.SUM,
                                   group=group)
        STATS.add(kind, mesh.key(axis), n,
                  xs.numel() * xs.element_size(), tag)
        return out.movedim(0, dim)
    if kind == "all-reduce":
        out = x.contiguous().clone()
        dist.all_reduce(out, op=_OPS[op], group=group)
        STATS.add(kind, mesh.key(axis), n,
                  out.numel() * out.element_size(), tag)
        return out
    raise ValueError(f"unknown collective {kind!r}")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, tag):
        ctx.args = (mesh, axis, dim, tag)
        return collective("all-gather", x, mesh, axis, dim=dim, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, tag = ctx.args
        return (collective("reduce-scatter", g, mesh, axis, dim=dim,
                           tag=tag), None, None, None, None)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        return collective("all-reduce", x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return collective("all-reduce", g, mesh, axis, tag=tag), None, \
            None, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, tag):
        ctx.args = (mesh, axis, tag)
        return collective("all-reduce", x, mesh, axis, tag=tag)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, tag = ctx.args
        return collective("all-reduce", g, mesh, axis, tag=tag), None, \
            None, None


def all_gather(x, mesh, axis, dim: int, tag: str = "step"):
    """Differentiable all-gather along ``dim`` (backward: reduce-scatter)."""
    if mesh.size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh, axis, dim, tag)


def all_reduce(x, mesh, axis, tag: str = "step"):
    """Differentiable all-reduce sum (backward: identity): Megatron's g."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduce.apply(x, mesh, axis, tag)


def copy_to(x, mesh, axis, tag: str = "step"):
    """Identity with an all-reduce sum of the gradient: Megatron's f."""
    if mesh.size(axis) == 1:
        return x
    return _CopyTo.apply(x, mesh, axis, tag)


def all_reduce_both(x, mesh, axis, tag: str = "step"):
    """Differentiable all-reduce sum whose backward all-reduces too."""
    if mesh.size(axis) == 1:
        return x
    return _AllReduceBoth.apply(x, mesh, axis, tag)


# ---------------------------------------------------------------------------
# One rank's share of the model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How a rank uses one parameter leaf: the dim its FSDP shard cuts
    (gathered at use; a dim "model" cuts stays local), the kv-head dim
    it narrows to the heads this rank's query heads read (kv heads
    replicated over "model" while the heads split), and whether the
    leaf, replicated over "model" and used whole, gets its gradient
    from this rank's heads only (``model_sum``: the SSD's B and C
    projections and convolutions where d_inner splits)."""

    fsdp_dim: int | None
    kv_dim: int | None
    model_sum: bool = False


class MeshShard:
    """What the model code needs of a training mesh on one rank (the
    ``par`` of ``models/transformer.py``): the rules' cuts of ``cfg``
    (``make_rules(cfg, mesh, kind="train")``), the leaf plans of every
    parameter subtree, and the collectives at the points the cuts need
    them. The model runs at one device's shapes, as ``launch/dryrun.py``
    ``device_config`` cuts them: heads, d_ff and vocab rows divided by
    the model size where they split, kv heads split with the heads or
    narrowed to the ones a rank's heads read.

    Every family splits: attention heads and d_ff (the encoder's, the
    decoder's self- and cross-attention, zamba2's shared block), the
    vocab, the MoE's experts' d_ff, and the SSD's d_inner and heads
    (``ssm_in``/``ssm_out`` around the block, ``norm_sum`` for its
    gated norm's statistic, ``model_sum`` on the leaves every rank uses
    whole for its own heads)."""

    def __init__(self, cfg, mesh):
        from repro_torch.launch.mesh import FSDP_AXES
        from repro_torch.models.convert import STACKED
        from repro_torch.models.params import leaf_axes, tree_paths_map
        from repro_torch.models.sharding import make_rules
        from repro_torch.models.ssm import MODEL_SUMMED
        from repro_torch.models.transformer import model_spec
        self.cfg, self.mesh = cfg, mesh
        self.rules = make_rules(cfg, mesh, kind="train")
        m = mesh.size("model")
        lookup = self.rules.params.lookup

        def split(name):
            return m > 1 and lookup(name) == "model"
        self.heads_split, self.ffn_split = split("heads"), split("ffn")
        self.vocab_split = split("vocab")
        self.inner_split = bool(cfg.ssm_state) and split("ssm_inner")
        if cfg.ssm_state and self.inner_split != split("ssm_heads"):
            raise ValueError(f"{cfg.name}: d_inner and the SSM heads split "
                             f"differently over {m} ranks")
        self.moe_shard_map = cfg.family == "moe" and self.ffn_split
        self.kv = None
        if self.heads_split and not split("kv_heads") and cfg.num_kv_heads:
            H, K = cfg.num_heads, cfg.num_kv_heads
            Hd, G, c = H // m, H // K, mesh.coord("model")
            lo, hi = (c * Hd) // G, ((c + 1) * Hd - 1) // G + 1
            if Hd % (hi - lo):
                raise ValueError(f"{cfg.name}: {Hd} heads per rank do not "
                                 f"group over {hi - lo} kv heads")
            self.kv = (lo, hi - lo)
        rows = cfg.vocab_padded() // (m if self.vocab_split else 1)
        self.vocab_lo = mesh.coord("model") * rows if self.vocab_split \
            else 0

        def plan(s):
            axes = leaf_axes(s, self.rules.params)
            fsdp = [i for i, a in enumerate(axes)
                    if a and set(a) <= set(FSDP_AXES)]
            kv = (s.names.index("kv_heads")
                  if self.kv is not None and "kv_heads" in s.names
                  else None)
            return LeafPlan(fsdp[0] if fsdp else None, kv)
        spec = model_spec(cfg)
        self.axes = {k: tree_paths_map(
            lambda s: leaf_axes(s, self.rules.params),
            v[0] if k in STACKED else v) for k, v in spec.items()}
        self.plans = {k: tree_paths_map(plan, v[0] if k in STACKED else v)
                      for k, v in spec.items()}
        if self.inner_split:
            ssm = self.plans["blocks"]["ssm"]
            for name in MODEL_SUMMED:
                ssm[name] = dataclasses.replace(ssm[name], model_sum=True)

    # -- parameters --------------------------------------------------------
    def _use(self, t, lp: LeafPlan):
        if lp.kv_dim is not None or lp.model_sum:
            # every model rank reads a slice, or reads it whole for its
            # own heads: the grads' sum over "model"
            t = copy_to(t, self.mesh, "model")
        if lp.fsdp_dim is not None:
            t = all_gather(t, self.mesh, "fsdp", lp.fsdp_dim)
        if lp.kv_dim is not None:
            t = t.narrow(lp.kv_dim, *self.kv)
        return t

    def use(self, p, key: str):
        """Subtree ``key``'s shards (a block of "blocks" or "enc_blocks",
        or a non-block subtree) at their compute shapes: FSDP shards
        gathered, kv leaves narrowed. Under a block's remat this runs in
        the forward and again in the recompute."""
        from repro_torch.utils import as_tree, tree_map
        return tree_map(self._use, as_tree(p), self.plans[key])

    def outer(self, params) -> dict:
        """The parameter tree with its non-block subtrees (the embedding
        and head, the final norms, zamba2's shared block) gathered once,
        outside every remat; the blocks stay shards, gathered in their
        block functions."""
        from repro_torch.models.convert import STACKED
        return {k: v if k in STACKED else self.use(v, k)
                for k, v in params.items()}

    # -- activations -------------------------------------------------------
    def attn_in(self, x):
        return copy_to(x, self.mesh, "model") if self.heads_split else x

    def attn_out(self, y):
        return all_reduce(y, self.mesh, "model") if self.heads_split else y

    def ffn_in(self, x):
        return copy_to(x, self.mesh, "model") if self.ffn_split else x

    def ffn_out(self, y):
        return all_reduce(y, self.mesh, "model") if self.ffn_split else y

    def ssm_in(self, x):
        return copy_to(x, self.mesh, "model") if self.inner_split else x

    def ssm_out(self, y):
        return all_reduce(y, self.mesh, "model") if self.inner_split else y

    def norm_sum(self, x):
        """The SSD gated norm's sum of squares over the d_inner slices
        (called only where d_inner splits): summed over "model" in the
        forward and in the backward (:func:`all_reduce_both`)."""
        return all_reduce_both(x, self.mesh, "model")

    # the vocab's: called only where the vocab splits (``vocab_split``)
    def vocab_in(self, h):
        return copy_to(h, self.mesh, "model")

    def vocab_sum(self, x):
        """Sum over the vocab shards (g: the backward is the identity)."""
        return all_reduce(x, self.mesh, "model")

    def vocab_max(self, x):
        return collective("all-reduce", x.detach(), self.mesh, "model",
                          op="max")

    def reduce_data(self, x):
        """Sum over the data shards of a statistic (tag "scalar")."""
        return all_reduce(x, self.mesh, "fsdp", tag="scalar")

    def gather_data(self, x):
        return collective("all-gather", x, self.mesh, "fsdp", tag="scalar")
