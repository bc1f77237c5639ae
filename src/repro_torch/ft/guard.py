"""In-step fault guards.

``quarantine_distances`` is the serving-side guard: it rewrites
individual corrupted distance entries to a sentinel (``BIG_DIST``)
*before* they enter the bitonic merge — a NaN that reaches the merge
network poisons every comparison downstream — and counts them, so
corruption shows up in the serving metrics rather than in the results.

``all_finite`` and ``select_tree`` are the step-level pair (a training
step suppressed when any gradient is non-finite), over trees of tensors:
dicts, lists, tuples and named tuples.
"""
from __future__ import annotations

import torch

#: distances at or below this are treated as corrupt garbage — no real
#: squared distance is negative, let alone -1e30
NEG_GARBAGE = -1.0e30


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [x for v in tree for x in _leaves(v)]


def _map2(fn, a, b):
    if isinstance(a, torch.Tensor):
        return fn(a, b)
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    vals = [_map2(fn, x, y) for x, y in zip(a, b)]
    return a._make(vals) if hasattr(a, "_make") else type(a)(vals)


def all_finite(tree) -> torch.Tensor:
    """0-d bool: every floating-point leaf is finite (integer and bool
    leaves are skipped; an empty tree is finite)."""
    ok = torch.ones((), dtype=torch.bool)
    for leaf in _leaves(tree):
        if leaf.is_floating_point():
            ok = ok.to(leaf.device) & torch.isfinite(leaf).all()
    return ok


def select_tree(pred, on_true, on_false):
    """Elementwise tree select: ``torch.where(pred, a, b)`` leaf by leaf
    (``pred`` a bool scalar or broadcastable against each leaf)."""
    return _map2(lambda a, b: torch.where(pred, a, b), on_true, on_false)


def quarantine_distances(dist, valid, fill, dim=None):
    """Replace corrupt entries of ``dist`` (NaN/inf, or impossibly
    negative — see :data:`NEG_GARBAGE`) with ``fill`` and count them.

    Only entries where ``valid`` count as quarantined: invalid slots
    are padding the caller already fills, not corruption. On clean data
    every entry passes the predicate and the ``where`` is the identity,
    so the guarded path stays bit-identical to the unguarded one.
    Returns ``(clean_dist, n_quarantined)``: an int32 total, or per
    index of the dims left after summing over ``dim``."""
    bad = valid & (~torch.isfinite(dist) | (dist <= NEG_GARBAGE))
    n = bad.sum() if dim is None else bad.sum(dim)
    return torch.where(bad, fill, dist), n.to(torch.int32)
