"""Train-step construction: gradient accumulation, clipping, NaN-guard
skip-step, AdamW (the reference's ``train/trainer.py`` in torch).

The reference returns one jit-compiled function that takes and returns
(params, opt_state); here the step runs eagerly and updates the
parameter module in place (its parameters keep their storage), while the
optimizer state is a tree of new tensors each step, as the reference's.
Nothing in a step reads the device from the host: the loss, the norm and
the finite flag stay 0-d tensors on the device.

On a training mesh (``make_train_step(..., mesh=)``: ``launch/mesh.py``
``TrainMesh``, one process per rank) the step takes the same global
batch and the rank's shards of the parameters and the optimizer state
(``models/convert.py`` ``shard_params``; :func:`shard_opt`):

  * each microbatch is this data shard's rows of the reference's
    microbatch (grad_accum splits the local batch, in the reference's
    microbatch order);
  * the model gathers each block's FSDP shards inside the block's remat
    unit (``models/transformer.py``), so their gradients leave the
    backward reduce-scattered; the gradients of leaves no data axis
    cuts are summed over the data axes once per step;
  * the global-norm clip reads every element once: each rank counts the
    leaves it owns (its coordinate is 0 on every axis that replicates
    the leaf), then one scalar all-reduce over the world;
  * the NaN guard's verdict is the world's (an all-reduce of the flag);
  * AdamW runs on the shards; the factored second moment's row and
    column means of a cut dim are all-reduced over the axes that cut it
    (``_shard_means``).

At world 1 no collective launches and the step is the one-device step.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.ft.guard import all_finite, select_tree
from repro_torch.models.convert import (STACKED, cut, param_axes, stacked,
                                        uncut, unstack_into)
from repro_torch.models.transformer import ModelOpts, init_params, loss_fn
from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     clip_by_global_norm, init_opt)
from repro_torch.train.parallel import MeshShard, collective
from repro_torch.utils import as_tree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    grad_accum: int = 1
    lb_coef: float = 0.01


def trainable(params):
    """Turn grad on for every parameter of the tree (``module_tree``
    makes them without it, for serving)."""
    for p in tree_leaves(as_tree(params)):
        p.requires_grad_(True)
    return params


def compute_grads(params, cfg: ArchConfig, batch, tc: TrainConfig,
                  opts: ModelOpts = ModelOpts(), par=None):
    """(loss, metrics, grads tree shaped as ``as_tree(params)``). With
    grad_accum G > 1 the batch is split into G micro-batches run one
    after the other, gradients accumulated in f32 as acc + g / G and
    the metrics averaged (activation memory / G). On a mesh (``par``)
    each micro-batch is this data shard's rows of it (module doc)."""
    tree = as_tree(trainable(params))
    leaves = tree_leaves(tree)
    G = tc.grad_accum
    if par is not None:
        return _mesh_grads(params, cfg, batch, tc, opts, par, leaves, tree)

    def micro(mb):
        loss, metrics = loss_fn(params, cfg, mb, opts=opts,
                                lb_coef=tc.lb_coef)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), {k: torch.as_tensor(v).detach()
                               for k, v in metrics.items()}, grads

    if G == 1:
        loss, metrics, grads = micro(batch)
    else:
        def split(x):
            return x.reshape((G, x.shape[0] // G) + tuple(x.shape[1:]))
        parts = {k: split(v) for k, v in batch.items()}
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves]
        loss, ms = 0.0, []
        for i in range(G):
            li, mi, gi = micro({k: v[i] for k, v in parts.items()})
            grads = [a + g.float() / G for a, g in zip(grads, gi)]
            loss = loss + li / G
            ms.append(mi)
        metrics = {k: torch.stack([m[k] for m in ms]).float().mean()
                   for k in ms[0]}
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), tree)


def _mesh_grads(params, cfg, batch, tc, opts, par, leaves, tree):
    """compute_grads on a mesh: the micro-batches' rows of this data
    shard, their gradients accumulated, then the sum over the data axes
    of the leaves no data axis cuts."""
    mesh, G = par.mesh, tc.grad_accum
    n, c = mesh.size("fsdp"), mesh.coord("fsdp")
    B = batch["tokens"].shape[0]
    if B % (G * n):
        raise ValueError(f"a batch of {B} rows does not split into {G} "
                         f"micro-batches over {n} data shards")
    per = B // G

    def rows(i):
        lo = i * per + c * (per // n)
        return {k: v[lo:lo + per // n] for k, v in batch.items()}

    grads, loss, ms = None, 0.0, []
    for i in range(G):
        li, mi = loss_fn(params, cfg, rows(i), opts=opts,
                         lb_coef=tc.lb_coef, par=par)
        gi = torch.autograd.grad(li, leaves, allow_unused=True,
                                 materialize_grads=True)
        if G == 1:
            grads, loss = list(gi), li.detach()
        else:
            if grads is None:
                grads = [torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device) for p in leaves]
            grads = [a + g.float() / G for a, g in zip(grads, gi)]
            loss = loss + li.detach() / G
        ms.append({k: torch.as_tensor(v).detach() for k, v in mi.items()})
    metrics = ms[0] if G == 1 else {
        k: torch.stack([m[k] for m in ms]).float().mean() for k in ms[0]}
    for i, rep in enumerate(tree_leaves(_leaf_info(par, tree)[0])):
        if rep:
            grads[i] = collective("all-reduce", grads[i], mesh, "fsdp")
    it = iter(grads)
    return loss, metrics, tree_map(lambda _: next(it), tree)


def _axes_tree(par, tree) -> dict:
    """Each leaf's per-dim mesh axes, shaped as ``tree`` (a parameter
    tree, or one shaped like it)."""
    return {k: [par.axes[k]] * len(v) if k in STACKED else par.axes[k]
            for k, v in tree.items()}


def _leaf_info(par, tree) -> tuple:
    """(data-replicated, owned) trees shaped as ``tree`` (a parameter
    tree): whether no data axis cuts the leaf (its gradient is summed
    over the data axes), and whether this rank counts it in the global
    norm (its coordinate is 0 on every mesh axis that does not cut it)."""
    mesh = par.mesh
    axes = _axes_tree(par, tree)

    def cuts(ax):
        return {a for dim in ax for a in dim}

    def replicated(t, ax):
        return mesh.size("fsdp") > 1 and not (
            cuts(ax) & set(mesh.names("fsdp")))

    def owned(t, ax):
        return all(mesh.coords[a] == 0 for a in mesh.axis_names
                   if a not in cuts(ax))
    return (tree_map(replicated, tree, axes), tree_map(owned, tree, axes))


def _shard_means(par) -> dict:
    """The factored statistics' ``mean`` per leaf (``optim/adamw.py``
    ``_vhat_factored``): a mean over a dim of the leaf that mesh axes cut
    sums the rank's rows, all-reduces the sum over those axes and
    divides by the full count. Which reduction: a matrix cut on its rows
    (FSDP on "embed" of wq, w1, the embedding) all-reduces its column
    statistic c and the rows' mean of r; one cut on its columns (TP on
    heads, ffn, vocab; FSDP on "embed" of wo, w2) all-reduces r; a
    stacked per-layer vector cut on its only dim (a norm scale under
    FSDP) all-reduces r."""
    mesh = par.mesh

    def mean_fn(axes):
        def mean(x, dim, leaf_dim):
            i = len(axes) + leaf_dim
            cut_by = axes[i] if 0 <= i < len(axes) else ()
            k = mesh.size(cut_by) if cut_by else 1
            if k == 1:
                return x.mean(dim=dim)
            s = collective("all-reduce", x.sum(dim=dim), mesh, cut_by,
                           tag="factored")
            return s / (x.shape[dim] * k)
        return mean
    return {k: tree_map(mean_fn, v) for k, v in par.axes.items()}


def update_step(params, grads, gnorm, loss, opt_state, oc: OptConfig,
                finite=None, means=None):
    """The step's update from its clipped gradients and their norm
    (``clip_by_global_norm``): AdamW, and the NaN-guard skip-step (an
    identity update on a non-finite step, whose counter still advances,
    so the schedule stays aligned with the data). ``params`` is updated
    in place. ``finite``: the guard's verdict where the caller decided
    it (a mesh's, for every rank); ``means``: ``apply_updates``'.
    Returns (params, opt_state, {"grad_norm", "skipped", "lr"})."""
    if finite is None:
        finite = all_finite(grads) & torch.isfinite(loss)
    new_params, new_opt = apply_updates(params, grads, opt_state, oc,
                                        means=means)
    with torch.no_grad():
        tree_map(lambda p, n: p.copy_(torch.where(finite, n, p)),
                 as_tree(params), new_params)
    opt_state = {
        "m": select_tree(finite, new_opt["m"], opt_state["m"]),
        "v": select_tree(finite, new_opt["v"], opt_state["v"]),
        "step": new_opt["step"],
    }
    return params, opt_state, {"grad_norm": gnorm,
                               "skipped": (~finite).to(torch.int32),
                               "lr": oc.lr_at(new_opt["step"])}


def make_train_step(cfg: ArchConfig, oc: OptConfig, tc: TrainConfig, *,
                    opts: ModelOpts = ModelOpts(), mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``params`` is the module tree (updated in place and
    returned); batch: tokens/labels (GB, S) [+ frontend (GB, F, d)].
    With ``mesh`` (a ``TrainMesh``) the step is one rank's: ``params``
    and ``opt_state`` its shards, ``batch`` the global batch (module
    doc)."""
    if mesh is not None:
        return _mesh_step(cfg, oc, tc, opts, MeshShard(cfg, mesh))

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, cfg, batch, tc, opts)
        # rebinding frees the unclipped grads before the update
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm)
        params, opt_state, extra = update_step(params, grads, gnorm, loss,
                                               opt_state, oc)
        metrics = dict(metrics)
        metrics.update(extra)
        return params, opt_state, metrics

    return train_step


def _mesh_step(cfg, oc, tc, opts, par):
    mesh = par.mesh
    means = _shard_means(par) if oc.factored_v else None

    def train_step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, cfg, batch, tc, opts,
                                             par)
        _, owned = _leaf_info(par, grads)
        sq = [torch.sum(torch.square(g.float()))
              for g, o in zip(tree_leaves(grads), tree_leaves(owned)) if o]
        sq = sum(sq) if sq else torch.zeros((), device=loss.device)
        gnorm = torch.sqrt(collective("all-reduce", sq, mesh, "world",
                                      tag="scalar"))
        scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        grads = tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)
        ok = (all_finite(grads) & torch.isfinite(loss)).to(torch.int32)
        finite = collective("all-reduce", ok, mesh, "world", op="min",
                            tag="scalar").bool()
        params, opt_state, extra = update_step(
            params, grads, gnorm, loss, opt_state, oc, finite=finite,
            means=means)
        metrics = dict(metrics)
        metrics.update(extra)
        return params, opt_state, metrics

    train_step.par = par
    return train_step


# ---------------------------------------------------------------------------
# Shards of the train state on a mesh
# ---------------------------------------------------------------------------
def _factored_axes(axes: tuple, stack: bool) -> dict:
    """The per-dim axes of a leaf's factored statistics (``optim/
    adamw.py``): r drops the leaf's last dim, c its second to last; a
    stacked leaf has the layer axis first (never cut)."""
    full = (((),) if stack else ()) + tuple(axes)
    if len(full) >= 2:
        return {"r": full[:-1], "c": full[:-2] + full[-1:]}
    return {"f": full}


def _state_axes(par, oc: OptConfig, params) -> dict:
    """Per-dim axes of every leaf of {"m", "v"}, shaped as the state."""
    tree = as_tree(params)
    m = _axes_tree(par, tree)
    if not oc.factored_v:
        return {"m": m, "v": m}
    v = {}
    for k, sub in tree.items():
        stack = k in STACKED and isinstance(sub, list)
        v[k] = tree_map(lambda ax, s=stack: _factored_axes(ax, s),
                        par.axes[k] if stack else m[k])
    return {"m": m, "v": v}


def _map_state(fn, state, axes):
    """``fn(tensor, axes)`` over {"m", "v"}, the step kept."""
    def walk(t, a):
        if isinstance(t, dict):
            return {k: walk(t[k], a[k]) for k in t}
        if isinstance(t, list):
            return [walk(x, y) for x, y in zip(t, a)]
        return fn(t, a)
    return {"m": walk(state["m"], axes["m"]), "v": walk(state["v"],
                                                        axes["v"]),
            "step": state["step"]}


def shard_opt(par, oc: OptConfig, params, opt) -> dict:
    """A full optimizer state (the one-device layout) -> this rank's
    shard, as ``shard_params`` cuts the parameters (``params``: the
    rank's shards, for the tree's shape)."""
    return _map_state(lambda t, a: cut(t, a, par.mesh), opt,
                      _state_axes(par, oc, params))


def gather_state(par, oc: OptConfig, params, opt) -> tuple:
    """(full parameters, full optimizer state) on every rank from the
    rank's shards (collective: every rank calls it)."""
    full_p = tree_map(lambda t, a: uncut(t.detach(), a, par.mesh),
                      as_tree(params), param_axes(par.cfg, par.rules))
    return full_p, _map_state(lambda t, a: uncut(t, a, par.mesh), opt,
                              _state_axes(par, oc, params))


def init_train_state(cfg: ArchConfig, oc: OptConfig, gen: torch.Generator,
                     param_dtype=torch.float32):
    """(trainable parameters drawn from ``gen`` on its device, a fresh
    optimizer state)."""
    params = trainable(init_params(cfg, gen, dtype=param_dtype))
    return params, init_opt(params, oc)


# ---------------------------------------------------------------------------
# Checkpoint layout: the reference's ({"params", "opt": {"m", "v",
# "step"}}, "blocks" stacked), so either package restores the other's
# ---------------------------------------------------------------------------
def state_tree(params, opt, leaf=lambda t: t.detach().cpu().numpy(),
               stack=np.stack) -> dict:
    """The train state in the reference's checkpoint layout (numpy by
    default)."""
    return {"params": stacked(params, leaf, stack),
            "opt": {"m": stacked(opt["m"], leaf, stack),
                    "v": stacked(opt["v"], leaf, stack),
                    "step": leaf(opt["step"])}}


def state_like(params, opt) -> dict:
    """:func:`state_tree`'s shapes and dtypes as "meta" tensors (no data):
    the ``like`` of ``checkpoint.restore``."""
    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def stack(ts):
        return torch.empty((len(ts),) + tuple(ts[0].shape),
                           dtype=ts[0].dtype, device="meta")
    return state_tree(params, opt, meta, stack)


def load_state(params, opt, tree) -> None:
    """Copy a restored :func:`state_tree` into ``params`` and ``opt`` in
    place."""
    unstack_into(params, tree["params"])
    for k in ("m", "v"):
        unstack_into(opt[k], tree["opt"][k])
    opt["step"].copy_(torch.as_tensor(tree["opt"]["step"]))
