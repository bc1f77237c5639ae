"""Carry weights between the reference's parameter tree and the port's.

The reference keeps its parameters as a nested dict whose ``"blocks"``
leaves carry a leading ``("layers", ...)`` axis (stacked for its layer
scan). The port keeps one module per layer. :func:`params_from_jax`
unstacks a reference tree given as numpy arrays; :func:`params_to_numpy`
stacks the port's module tree back into that form.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import module_tree
from repro_torch.models.transformer import model_spec
from repro_torch.utils import resolve_device


def params_from_jax(cfg: ArchConfig, tree, device="cuda") -> nn.Module:
    """Reference parameter tree (numpy arrays, stacked "blocks") -> the
    port's module tree on ``device``, each array's dtype kept."""
    device = resolve_device(device)

    def to_tensor(path, s):
        sub, keys = tree, path
        if path[0] == "blocks":      # ("blocks", layer, ...): stacked leaf
            sub, keys = tree["blocks"], path[2:]
        for key in keys:
            sub = sub[key]
        a = np.asarray(sub)
        if path[0] == "blocks":
            a = a[path[1]]
        if tuple(a.shape) != s.shape:
            raise ValueError(f"{'/'.join(map(str, path))}: shape "
                             f"{a.shape}, expected {s.shape}")
        return torch.tensor(a, device=device)

    return module_tree(model_spec(cfg), to_tensor)


def params_to_numpy(params: nn.Module) -> dict:
    """The port's module tree -> the reference's tree layout as numpy
    arrays, with the per-layer leaves stacked along a leading axis."""
    def leaf(t):
        return t.detach().cpu().numpy()

    out = {k: {n: leaf(t) for n, t in params[k].items()}
           for k in ("tok", "fln")}
    blocks = params["blocks"]
    out["blocks"] = {
        g: {n: np.stack([leaf(b[g][n]) for b in blocks])
            for n in blocks[0][g].keys()}
        for g in blocks[0].keys()}
    return out
