"""Minimal parameter system: specs with logical axis names.

Models declare their parameters as trees (nested dicts and lists) of
``ParamSpec`` (shape + dtype + logical axis names + init). From one spec
tree :func:`materialize` draws the random-init parameters as a module
tree: a dict of leaves becomes an ``nn.ParameterDict``, a dict of
subtrees an ``nn.ModuleDict``, a list an ``nn.ModuleList``. So the
model code indexes parameters as the reference indexes its dict tree
(``p["attn"]["wq"]``), and the whole tree is one ``nn.Module``.

The axis names are kept for the multi-device slice (sharding rules);
one device needs none of them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

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
