"""Train-step construction: gradient accumulation, clipping, NaN-guard
skip-step, AdamW (the reference's ``train/trainer.py`` in torch).

The reference returns one jit-compiled function that takes and returns
(params, opt_state); here the step runs eagerly and updates the
parameter module in place (its parameters keep their storage), while the
optimizer state is a tree of new tensors each step, as the reference's.
Nothing in a step reads the device from the host: the loss, the norm and
the finite flag stay 0-d tensors on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.ft.guard import all_finite, select_tree
from repro_torch.models.convert import stacked, unstack_into
from repro_torch.models.transformer import ModelOpts, init_params, loss_fn
from repro_torch.optim.adamw import (OptConfig, apply_updates,
                                     clip_by_global_norm, init_opt)
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
                  opts: ModelOpts = ModelOpts()):
    """(loss, metrics, grads tree shaped as ``as_tree(params)``). With
    grad_accum G > 1 the batch is split into G micro-batches run one
    after the other, gradients accumulated in f32 as acc + g / G and
    the metrics averaged (activation memory / G)."""
    tree = as_tree(trainable(params))
    leaves = tree_leaves(tree)
    G = tc.grad_accum

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


def update_step(params, grads, gnorm, loss, opt_state, oc: OptConfig):
    """The step's update from its clipped gradients and their norm
    (``clip_by_global_norm``): AdamW, and the NaN-guard skip-step (an
    identity update on a non-finite step, whose counter still advances,
    so the schedule stays aligned with the data). ``params`` is updated
    in place. Returns (params, opt_state, {"grad_norm", "skipped",
    "lr"})."""
    finite = all_finite(grads) & torch.isfinite(loss)
    new_params, new_opt = apply_updates(params, grads, opt_state, oc)
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
                    opts: ModelOpts = ModelOpts()):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics). ``params`` is the module tree (updated in place and
    returned); batch: tokens/labels (GB, S) [+ frontend (GB, F, d)]."""

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
