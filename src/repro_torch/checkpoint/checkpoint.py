"""Atomic, keep-k checkpoints in the reference's on-disk format (the
reference's ``checkpoint/checkpoint.py`` in torch and numpy).

Layout:  <dir>/step_<k>/shard-<proc>.npz   (one file per process)
         <dir>/step_<k>/META.json          (step, process count, keys;
written last: its presence marks the checkpoint COMMITTED, and an
interrupted save is invisible to restore)

A tree is nested dicts and lists of tensors or numpy arrays; its npz
keys are the paths to its leaves joined by ``::`` (list positions as
numbers), as the reference names them, so a checkpoint written by
either package restores in the other when the trees have one layout
(the trainer saves the reference's stacked layout, ``train_state_tree``).

In place of the reference's elastic re-shard (``device_put`` onto a
target mesh's shardings), :func:`restore` puts every array on the device
of the matching leaf of ``like``, or on the ``device`` it is given.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile

import numpy as np
import torch

SEP = "::"


def _flatten(tree, prefix=()) -> dict:
    """{key: leaf} over a dict / list tree, keys joined by SEP."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {SEP.join(prefix): tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (str(k),)))
    return out


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save(directory: str, step: int, tree, *, keep: int = 3,
         extra: dict | None = None) -> str:
    """Atomic save from one process: the shard file, then META.json and
    the pruning to the newest ``keep`` steps. (The reference writes one
    shard per host process; the port's trainer is one process, and
    :func:`restore` reads every shard META lists.)"""
    flat = {k: _to_numpy(v) for k, v in _flatten(tree).items()}
    sdir = _step_dir(directory, step)
    os.makedirs(sdir, exist_ok=True)

    fd, tmp = tempfile.mkstemp(dir=sdir, suffix=".tmp.npz")
    os.close(fd)
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, os.path.join(sdir, "shard-0.npz"))

    meta = {"step": step, "num_processes": 1, "keys": sorted(flat),
            "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=sdir, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(sdir, "META.json"))
    _prune(directory, keep)
    return sdir


def _prune(directory: str, keep: int):
    steps = all_steps(directory)
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def all_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(directory, name, "META.json")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str):
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _rebuild(like, data: dict, sdir: str, device, prefix=()):
    if isinstance(like, dict):
        return {k: _rebuild(v, data, sdir, device, prefix + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return [_rebuild(v, data, sdir, device, prefix + (str(i),))
                for i, v in enumerate(like)]
    key = SEP.join(prefix)
    if key not in data:
        raise KeyError(f"checkpoint {sdir} missing {key}")
    arr = data[key]
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"{key}: ckpt shape {arr.shape} != "
                         f"{tuple(like.shape)}")
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(arr).to(
            device=like.device if device is None else device,
            dtype=like.dtype)
    return arr.astype(like.dtype)


def restore(directory: str, like, *, step: int | None = None, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, numpy
    arrays, or anything with ``shape`` and ``dtype``, e.g. tensors on
    the "meta" device). Each tensor leaf comes back on ``device``, or on
    its ``like`` leaf's device; a numpy leaf as numpy. Returns (step,
    tree, extra)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    sdir = _step_dir(directory, step)
    with open(os.path.join(sdir, "META.json")) as f:
        meta = json.load(f)

    data: dict[str, np.ndarray] = {}
    for p in range(meta["num_processes"]):
        path = os.path.join(sdir, f"shard-{p}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                for k in z.files:
                    data[k] = z[k]
    return step, _rebuild(like, data, sdir, device), meta["extra"]
