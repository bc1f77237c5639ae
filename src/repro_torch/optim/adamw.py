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
"""
from __future__ import annotations

import dataclasses

import torch

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


def _factored(p) -> bool:
    return p.dim() >= 2


def init_opt(params, oc: OptConfig) -> dict:
    """{"m", "v", "step"}: zero moments shaped like ``params`` (a module
    tree or a dict / list tree) and a 0-d int32 step on their device."""
    params = as_tree(params)

    def zeros(p, shape=None, dtype=torch.float32):
        return torch.zeros(p.shape if shape is None else shape, dtype=dtype,
                           device=p.device)

    m = tree_map(lambda p: zeros(p, dtype=oc.m_dtype), params)
    if oc.factored_v:
        def vinit(p):
            if _factored(p):
                return {"r": zeros(p, p.shape[:-1]),
                        "c": zeros(p, p.shape[:-2] + p.shape[-1:])}
            return {"f": zeros(p)}
        v = tree_map(vinit, params)
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


def _vhat_factored(v, g2, b2):
    """Update factored stats and return the reconstructed second moment."""
    if "f" in v:
        f = b2 * v["f"] + (1 - b2) * g2
        return {"f": f}, f
    r = b2 * v["r"] + (1 - b2) * g2.mean(dim=-1)
    c = b2 * v["c"] + (1 - b2) * g2.mean(dim=-2)
    denom = torch.clamp(r.mean(dim=-1, keepdim=True), min=1e-30)
    vhat = (r / denom)[..., None] * c[..., None, :]
    return {"r": r, "c": c}, vhat


def apply_updates(params, grads, state, oc: OptConfig, lr=None):
    """One AdamW step. Returns (new params tree, new state), all new
    tensors (the caller decides whether to keep them)."""
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

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        if oc.factored_v:
            v_new, vhat = _vhat_factored(v, gf * gf, b2)
        else:
            v_new = b2 * v.float() + (1 - b2) * gf * gf
            vhat = v_new
        u = (m_new / bc1) / (torch.sqrt(vhat / bc2) + oc.eps)
        pf = p.detach().float()
        p_new = pf - lr * (u + oc.weight_decay * pf)
        if not oc.factored_v:
            v_new = v_new.to(oc.v_dtype)
        return p_new.to(p.dtype), m_new.to(oc.m_dtype), v_new

    # a factored v leaf is a dict: tree_map hands it to upd whole
    outs = tree_map(upd, params, grads, state["m"], state["v"])
    new = [tree_map(lambda o, i=i: o[i], outs) for i in range(3)]
    return new[0], {"m": new[1], "v": new[2], "step": step}
