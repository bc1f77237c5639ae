"""Carry weights between the reference's parameter tree and the port's.

The reference keeps its parameters as a nested dict whose ``"blocks"``
(and encdec's ``"enc_blocks"``) leaves carry a leading ``("layers",
...)`` axis (stacked for its layer scan); every other subtree (the
embedding, the norms, zamba2's one ``"shared"`` block) is unstacked.
The port keeps one module per layer. :func:`params_from_jax` unstacks a
reference tree given as numpy arrays; :func:`params_to_numpy` stacks the
port's module tree back into that form; :func:`stacked` and
:func:`unstack_into` carry any tree shaped like the parameters (the
optimizer's moments) between the two layouts, as the checkpoints of the
training path need. A subtree that is already in the reference's
layout (the factored second moment of ``optim/adamw.py``, which it
holds stacked) passes through both as it is.

On a training mesh (``launch/mesh.py`` ``TrainMesh``) :func:`shard_params`
cuts a full parameter tree into one rank's shard, as the rules'
parameter table cuts each leaf (``leaf_axes``: FSDP on "embed" over the
data axes, heads, kv heads, ffn, vocab and the SSM widths over "model",
experts whole), and :func:`gather_params` joins the shards again (an
all-gather per cut dim). :func:`cut` and :func:`uncut` do the same for
any tensor given its per-dim axes (the optimizer's moments).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import (leaf_axes, local_shape, module_tree,
                                       pspec_of, tree_paths_map)
from repro_torch.models.transformer import model_spec
from repro_torch.utils import as_tree, resolve_device, tree_map

# the subtrees whose leaves the reference stacks along a layer axis
STACKED = ("blocks", "enc_blocks")


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> nn.Module:
    """Reference parameter tree (numpy arrays, stacked "blocks") -> the
    port's module tree on ``device``, each array's dtype kept."""
    device = resolve_device(device)

    def to_tensor(path, s):
        stacked = path[0] in STACKED   # (group, layer, ...): stacked leaf
        sub = tree[path[0]]
        for key in path[2:] if stacked else path[1:]:
            sub = sub[key]
        a = np.asarray(sub)
        if stacked:
            a = a[path[1]]
        if tuple(a.shape) != s.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{a.shape}, expected {s.shape}")
        return torch.tensor(a, device=device)

    return module_tree(model_spec(cfg), to_tensor)


def stacked(tree, leaf=lambda t: t.detach().cpu().numpy(),
            stack=np.stack) -> dict:
    """A port tree (a parameter module tree, or a dict tree shaped like
    one: an optimizer moment) -> the reference's layout: ``leaf`` of
    every leaf, the per-layer leaves of "blocks" and "enc_blocks" joined
    by ``stack`` along a leading axis."""
    def join(trees):
        if isinstance(trees[0], dict):
            return {k: join([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    tree = as_tree(tree)
    return {k: join([tree_map(leaf, b) for b in v])
            if k in STACKED and isinstance(v, list)
            else tree_map(leaf, v) for k, v in tree.items()}


def unstack_into(tree, ref) -> None:
    """Copy a tree in the reference's layout (arrays or tensors, stacked
    "blocks") into the port tree ``tree`` in place (each leaf keeps its
    device and dtype)."""
    tree = as_tree(tree)
    for k, v in tree.items():
        parts = ([(b, tree_map(lambda a, i=i: a[i], ref[k]))
                  for i, b in enumerate(v)]
                 if k in STACKED and isinstance(v, list) else [(v, ref[k])])
        for dst, src in parts:
            tree_map(lambda d, s: d.data.copy_(torch.as_tensor(s)), dst, src)


def params_to_numpy(params: nn.Module) -> dict:
    """The port's module tree -> the reference's tree layout as numpy
    arrays, with the per-layer leaves stacked along a leading axis."""
    return stacked(params)


# ---------------------------------------------------------------------------
# Shards on a training mesh
# ---------------------------------------------------------------------------
def cut(t: torch.Tensor, axes: tuple, mesh) -> torch.Tensor:
    """This rank's shard of the full tensor ``t``: dim i cut into
    ``mesh.size(axes[i])`` equal slices, the rank's by its coordinate on
    those axes (a copy; ``t`` itself where nothing cuts it)."""
    out = t
    for i, a in enumerate(axes):
        k = mesh.size(a) if a else 1
        if k > 1:
            n = t.shape[i] // k
            out = out.narrow(i, mesh.coord(a) * n, n)
    return t if out is t else out.clone()


def uncut(t: torch.Tensor, axes: tuple, mesh,
          tag: str = "checkpoint") -> torch.Tensor:
    """The full tensor from every rank's :func:`cut` (collective: every
    rank of the mesh calls it)."""
    from repro_torch.train.parallel import collective   # lazy: cycle
    for i, a in enumerate(axes):
        if a and mesh.size(a) > 1:
            t = collective("all-gather", t, mesh, a, dim=i, tag=tag)
    return t


def param_axes(cfg: ArchConfig, rules) -> dict:
    """The per-dim mesh axes of every leaf of ``cfg``'s parameter tree
    (``rules``: ``make_rules``' MeshRules), shaped as the tree."""
    return tree_paths_map(lambda s: leaf_axes(s, rules.params),
                          model_spec(cfg))


def shard_params(module, rules, mesh, cfg: ArchConfig) -> nn.Module:
    """A full parameter module tree -> this rank's shard of it, a new
    module tree on the same device (``params_from_jax`` then
    ``shard_params`` carries the reference's weights to every rank)."""
    full = as_tree(module)

    def leaf(path, s):
        t = full
        for k in path:
            t = t[k]
        out = cut(t.detach(), leaf_axes(s, rules.params), mesh)
        want = local_shape(s.shape, pspec_of(s, rules.params), mesh.shape)
        if tuple(out.shape) != want:
            raise ValueError(f"{'/'.join(map(str, path))}: shard "
                             f"{tuple(out.shape)}, the rules give {want}")
        return out

    return module_tree(model_spec(cfg), leaf)


def gather_params(module, rules, mesh, cfg: ArchConfig) -> dict:
    """The inverse of :func:`shard_params`: the full tree (dicts and
    lists of tensors) on every rank."""
    return tree_map(lambda t, a: uncut(t.detach(), a, mesh),
                    as_tree(module), param_axes(cfg, rules))
