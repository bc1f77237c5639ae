"""AdamW with configurable moment dtypes and an optional factored second
moment (Adafactor-style) for the 100B+ archs (the reference's
``optim/adamw.py`` in torch).

The state is a tree shaped like the parameters (``as_tree`` of the
module tree: dicts and lists of tensors) plus a 0-d int32 step counter on
the parameters' device, and every function here is elementwise per leaf
and returns new tensors, as the reference's. ``torch.optim.AdamW`` is no
substitute: the reference puts eps outside the bias-corrected square
root, takes its rate from the schedule at the incremented step, and
factors v.

The factored second moment is the reference's on the reference's layout:
a subtree that the reference stacks along a layer axis (``STACKED``:
"blocks", "enc_blocks"), which the port keeps as a list of per-layer
trees, holds its factored v stacked, one leaf per leaf of a block. A
per-layer matrix (a, b) is stacked as (L, a, b) and factors per layer,
``r: (L, a)``, ``c: (L, b)``; a per-layer vector (d,) is stacked as
(L, d) and factors across the layers, ``r: (L,)`` and one shared
``c: (d,)``; a per-layer scalar keeps ``{"f": (L,)}``. So the state
and its checkpoint equal the reference's leaf for leaf.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.convert import STACKED
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.utils import as_tree, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr_max: float = 3e-4
    schedule: str = "warmup_cosine"
    warmup: int = 100
    decay_steps: int = 10000
    lr_min_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    m_dtype: torch.dtype = torch.float32
    v_dtype: torch.dtype = torch.float32
    factored_v: bool = False      # factored 2nd moment for ndim>=2 params

    def lr_at(self, step):
        return SCHEDULES[self.schedule](
            step, lr_max=self.lr_max, warmup=self.warmup,
            decay_steps=self.decay_steps, lr_min_ratio=self.lr_min_ratio)


def _factored_init(shape, device) -> dict:
    """Zero factored statistics of a leaf of the reference's ``shape``:
    r/c for two or more dims, else a full ``f``."""
    def zeros(sh):
        return torch.zeros(sh, dtype=torch.float32, device=device)
    if len(shape) >= 2:
        return {"r": zeros(shape[:-1]), "c": zeros(shape[:-2] + shape[-1:])}
    return {"f": zeros(shape)}


def _zip_layers(layers: list):
    """Per-layer trees -> one tree whose leaves are tuples of the
    layers' leaves."""
    return tree_map(lambda *xs: tuple(xs), layers[0], *layers[1:])


def init_opt(params, oc: OptConfig) -> dict:
    """{"m", "v", "step"}: zero moments shaped like ``params`` (a module
    tree or a dict / list tree) and a 0-d int32 step on their device."""
    params = as_tree(params)

    def zeros(p, shape=None, dtype=torch.float32):
        return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                           device=p.device)

    m = tree_map(lambda p: zeros(p, dtype=oc.m_dtype), params)
    if oc.factored_v:
        v = {}
        for k, sub in params.items():
            if k in STACKED and isinstance(sub, list):
                v[k] = tree_map(lambda p, L=len(sub): _factored_init(
                    (L,) + tuple(p.shape), p.device), sub[0])
            else:
                v[k] = tree_map(lambda p: _factored_init(tuple(p.shape),
                                                         p.device), sub)
    else:
        v = tree_map(lambda p: zeros(p, dtype=oc.v_dtype), params)
    device = tree_leaves(params)[0].device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(as_tree(tree))
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), the norm)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype),
                    as_tree(grads)), gn


def _mean(x, dim, leaf_dim):
    return x.mean(dim=dim)


def _vhat_factored(v, g2, b2, mean=_mean):
    """Update factored stats and return the reconstructed second moment.
    ``mean(x, dim, leaf_dim)`` is x's mean over ``dim``, which is the
    leaf's (negative) dim ``leaf_dim``: on a mesh it reduces over the
    ranks that cut that dim of the leaf (``train/trainer.py``)."""
    if "f" in v:
        f = b2 * v["f"] + (1 - b2) * g2
        return {"f": f}, f
    r = b2 * v["r"] + (1 - b2) * mean(g2, -1, -1)
    c = b2 * v["c"] + (1 - b2) * mean(g2, -2, -2)
    denom = torch.clamp(mean(r, -1, -2).unsqueeze(-1), min=1e-30)
    vhat = (r / denom)[..., None] * c[..., None, :]
    return {"r": r, "c": c}, vhat


def apply_updates(params, grads, state, oc: OptConfig, lr=None,
                  means=None):
    """One AdamW step. Returns (new params tree, new state), all new
    tensors (the caller decides whether to keep them). ``means``: a tree
    shaped like ``params`` ("blocks" as one block's) of the factored
    statistics' ``mean`` per leaf (:func:`_vhat_factored`); None, the
    plain means of one device."""
    params, grads = as_tree(params), as_tree(grads)
    step = state["step"] + 1
    if lr is None:
        lr = oc.lr_at(step)
    b1, b2 = oc.b1, oc.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                     device=stepf.device), stepf)

    def upd(p, g, m, v, mean=_mean):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        if oc.factored_v:
            v_new, vhat = _vhat_factored(v, gf * gf, b2, mean)
        else:
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            vhat = v_new
        u = (m_new / bc1) / (torch.sqrt(vhat / bc2) + oc.eps)
        pf = p.detach().float()
        p_new = pf - lr * (u + oc.weight_decay * pf)
        if not oc.factored_v:
            v_new = v_new.to(oc.v_dtype)
        return p_new.to(p.dtype), m_new.to(oc.m_dtype), v_new

    def upd_layers(ps, gs, ms, v, mean=_mean):
        """A stacked leaf under factored v: ``ps``, ``gs``, ``ms`` the
        layers' tensors, ``v`` its stacked statistics (module doc)."""
        gfs = [g.float() for g in gs]
        if ps[0].dim() >= 2:
            outs = [_vhat_factored({k: x[i] for k, x in v.items()},
                                   gf * gf, b2, mean)
                    for i, gf in enumerate(gfs)]
            v_new = {k: torch.stack([o[0][k] for o in outs]) for k in v}
            vhats = [o[1] for o in outs]
        else:
            v_new, vhat = _vhat_factored(
                v, torch.stack([gf * gf for gf in gfs]), b2, mean)
            vhats = vhat.unbind(0)
        ps_new, ms_new = [], []
        for p, gf, m, vhat in zip(ps, gfs, ms, vhats):
            m_new = b1 * m.float() + (1 - b1) * gf
            u = (m_new / bc1) / (torch.sqrt(vhat / bc2) + oc.eps)
            pf = p.detach().float()
            ps_new.append((pf - lr * (u + oc.weight_decay * pf)).to(p.dtype))
            ms_new.append(m_new.to(oc.m_dtype))
        return tuple(ps_new), tuple(ms_new), v_new

    new = [{}, {}, {}]
    for k, sub in params.items():
        extra = () if means is None else (means[k],)
        if oc.factored_v and k in STACKED and isinstance(sub, list):
            outs = tree_map(upd_layers, _zip_layers(sub),
                            _zip_layers(grads[k]), _zip_layers(state["m"][k]),
                            state["v"][k], *extra)
            for j in range(2):
                new[j][k] = [tree_map(lambda o, i=i, j=j: o[j][i], outs)
                             for i in range(len(sub))]
            new[2][k] = tree_map(lambda o: o[2], outs)
            continue
        # a factored v leaf is a dict: tree_map hands it to upd whole
        if extra and k in STACKED and isinstance(sub, list):
            extra = ([extra[0]] * len(sub),)
        outs = tree_map(upd, sub, grads[k], state["m"][k], state["v"][k],
                        *extra)
        for j in range(3):
            new[j][k] = tree_map(lambda o, j=j: o[j], outs)
    return new[0], {"m": new[1], "v": new[2], "step": step}
