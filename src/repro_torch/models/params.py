"""Minimal parameter system: specs with logical axis names.

Models declare their parameters as trees (nested dicts and lists) of
``ParamSpec`` (shape + dtype + logical axis names + init). From one spec
tree :func:`materialize` draws the random-init parameters as a module
tree: a dict of leaves becomes an ``nn.ParameterDict``, a dict of
subtrees an ``nn.ModuleDict``, a list an ``nn.ModuleList``. So the
model code indexes parameters as the reference indexes its dict tree
(``p["attn"]["wq"]``), and the whole tree is one ``nn.Module``.

The axis names map to mesh axes through :class:`ShardingRules`
(``models/sharding.py`` builds them): :func:`pspec_of` gives a leaf's
partition spec as a plain tuple of entries (a mesh axis name, a tuple
of names, or None), trailing Nones dropped as the reference drops them.
The port's per-layer leaves carry no ``"layers"`` axis, so each spec is
the reference's without its leading entry (which the reference maps to
None everywhere). The planner (``launch/specs.py``) and the dry run
read these specs; one device applies none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    names: tuple            # logical axis name per dim (None = unsharded)
    dtype: torch.dtype = torch.float32
    init: str = "normal"    # normal | zeros | ones
    scale: Optional[float] = None  # None -> 1/sqrt(fan_in)


def spec(shape, names, dtype=torch.float32, init="normal", scale=None):
    assert len(shape) == len(names), (shape, names)
    return ParamSpec(tuple(shape), tuple(names), dtype, init, scale)


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_paths_map(fn, tree):
    """``fn`` over the ParamSpec leaves of a spec tree (nested dicts and
    lists), the structure kept."""
    if isinstance(tree, dict):
        return {k: tree_paths_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_paths_map(fn, v) for v in tree]
    return fn(tree)


def spec_leaves(tree) -> list:
    """The ParamSpec leaves of a spec tree in :func:`module_tree`'s
    order (dict keys sorted): the order of the parameters of the module
    it makes."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


def spec_paths(tree, path=()) -> list:
    """The paths (tuples of keys and indices) of :func:`spec_leaves`'
    leaves, in the same order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in spec_paths(tree[k],
                                                             path + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in spec_paths(v, path + (i,))]
    return [path]


def count_params(spec_tree) -> int:
    total = 0
    for s in spec_leaves(spec_tree):
        n = 1
        for d in s.shape:
            n *= d
        total += n
    return total


# ---------------------------------------------------------------------------
# Sharding rules: logical axis name -> mesh axis (or tuple, or None)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    table: tuple  # (logical, physical) pairs; physical: str|tuple|None

    def lookup(self, name) -> Any:
        for k, v in self.table:
            if k == name:
                return v
        return None

    @staticmethod
    def of(mapping: Mapping[str, Any]) -> "ShardingRules":
        return ShardingRules(tuple(mapping.items()))


def _trim(axes: tuple) -> tuple:
    while axes and axes[-1] is None:
        axes = axes[:-1]
    return axes


def pspec_of(s: ParamSpec, rules: ShardingRules) -> tuple:
    return _trim(tuple(rules.lookup(n) for n in s.names))


def param_pspecs(spec_tree, rules: ShardingRules):
    return tree_paths_map(lambda s: pspec_of(s, rules), spec_tree)


def logical_pspec(names: Sequence, rules: Optional[ShardingRules]) -> tuple:
    if rules is None:
        return ()
    return _trim(tuple(rules.lookup(n) for n in names))


def pspec_axes(entry) -> tuple:
    """The mesh axis names of one pspec entry (None, a name, or a tuple
    of names)."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(a for e in entry for a in pspec_axes(e))


def leaf_axes(s: ParamSpec, rules: ShardingRules) -> tuple:
    """Per dim of a leaf, the mesh axes that cut it (``()`` where the dim
    stays whole)."""
    ps = pspec_of(s, rules)
    return tuple(pspec_axes(ps[i] if i < len(ps) else None)
                 for i in range(len(s.shape)))


def local_shape(shape, pspec: tuple, sizes: Mapping[str, int]) -> tuple:
    """A tensor's shape on one device: each dim divided by the product
    of its entry's mesh axis sizes (which must divide it)."""
    out = []
    for i, dim in enumerate(shape):
        f = 1
        for a in pspec_axes(pspec[i] if i < len(pspec) else None):
            f *= sizes[a]
        if dim % f:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split "
                             f"over {pspec} on {dict(sizes)}")
        out.append(dim // f)
    return tuple(out)


def _draw(s: ParamSpec, gen: torch.Generator, dtype, device) -> torch.Tensor:
    dt = dtype or s.dtype
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=dt, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=dt, device=device)
    fan_in = s.shape[0] if len(s.shape) >= 1 else 1
    scale = s.scale if s.scale is not None else fan_in ** -0.5
    x = torch.randn(s.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dt)


def module_tree(tree, leaf, path=()) -> nn.Module:
    """Map a spec tree to a module tree, ``leaf(path, spec) -> tensor``
    (``path`` the keys and list positions down to the leaf), in the
    reference's flatten order (so one generator draws the leaves in the
    same sequence on every run). Parameters are made with
    ``requires_grad=False``: the trainer (``train/trainer.py``) turns
    grad on for the tree it trains, and serving keeps it off
    (``prefill`` and ``decode_step`` also run under ``torch.no_grad``),
    so serving builds no autograd graph."""
    if isinstance(tree, dict):
        if all(is_spec(v) for v in tree.values()):
            return nn.ParameterDict({
                k: nn.Parameter(leaf(path + (k,), tree[k]),
                                requires_grad=False)
                for k in sorted(tree)})
        return nn.ModuleDict({k: module_tree(tree[k], leaf, path + (k,))
                              for k in sorted(tree)})
    return nn.ModuleList([module_tree(t, leaf, path + (i,))
                          for i, t in enumerate(tree)])


def materialize(spec_tree, gen: torch.Generator, dtype=None) -> nn.Module:
    """Random-init the parameter tree. Every leaf is drawn from ``gen``,
    on ``gen``'s device: a CUDA generator puts the model on the card
    without a host copy."""
    return module_tree(spec_tree,
                       lambda _, s: _draw(s, gen, dtype, gen.device))
