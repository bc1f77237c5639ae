"""Carry weights between the reference's parameter tree and the port's.

The reference keeps its parameters as a nested dict whose ``"blocks"``
(and encdec's ``"enc_blocks"``) leaves carry a leading ``("layers",
...)`` axis (stacked for its layer scan); every other subtree (the
embedding, the norms, zamba2's one ``"shared"`` block) is unstacked.
The port keeps one module per layer. :func:`params_from_jax` unstacks a
reference tree given as numpy arrays; :func:`params_to_numpy` stacks the
port's module tree back into that form.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import module_tree
from repro_torch.models.transformer import model_spec
from repro_torch.utils import resolve_device

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


def params_to_numpy(params: nn.Module) -> dict:
    """The port's module tree -> the reference's tree layout as numpy
    arrays, with the per-layer leaves stacked along a leading axis."""
    def tree(m):
        if isinstance(m, torch.Tensor):
            return m.detach().cpu().numpy()
        return {k: tree(v) for k, v in m.items()}

    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return np.stack(trees)

    return {k: stack([tree(b) for b in m]) if k in STACKED else tree(m)
            for k, m in params.items()}
