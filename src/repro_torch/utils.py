"""Small shared utilities: sentinels, shape math, device choice, byte
counts, and the visited-set bloom filter.

The bloom keeps the reference's two multiplicative hashes bit for bit,
but stores its bits as a boolean map ``(..., num_bits)`` instead of
packed uint32 words: torch has no ``>>`` on uint32 tensors on the CPU,
and setting a bit is then a plain scatter of ``True`` (colliding writes
all write the same value, so they need no OR-reduction).
:func:`bloom_pack` folds a map into the reference's uint32 words.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Large-but-finite sentinel distance (f32). Avoids +inf so (inf - inf)
# NaNs never appear in masked arithmetic.
BIG_DIST = 3.0e38
INVALID = -1
ID_SENTINEL = 2**31 - 1


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 2 ** math.ceil(math.log2(n))


def pad_axis(x: np.ndarray, size: int, axis: int, fill=0) -> np.ndarray:
    """Pad a numpy array along ``axis`` up to ``size`` with ``fill``."""
    cur = x.shape[axis]
    if cur == size:
        return x
    assert cur < size, f"cannot pad {cur} down to {size}"
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, size - cur)
    return np.pad(x, widths, constant_values=fill)


def tree_bytes(tree) -> int:
    """Bytes of every leaf with a shape and a dtype (tensors, numpy
    arrays) of a dict / list tree or a module tree."""
    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
    return sum(nbytes(x) for x in tree_leaves(as_tree(tree))
               if hasattr(x, "shape") and hasattr(x, "dtype"))


def human_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024:
            return f"{n:.2f}{unit}"
        n /= 1024
    return f"{n:.2f}PiB"


def to_host(*tensors) -> list:
    """Tensors -> numpy arrays with one wait for the device: the copies
    are queued without blocking and the host synchronises once."""
    if tensors[0].is_cuda:
        out = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream(tensors[0].device).synchronize()
    else:
        out = tensors
    return [t.numpy() for t in out]


def to_device(x, device) -> torch.Tensor:
    """A host array as a tensor on ``device``, without a wait: a copy to a
    card goes through pinned memory, queued on the current stream."""
    t = torch.as_tensor(x)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is present: the port never falls
    back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


class HostStaging:
    """Host staging buffers for copies to the device, reused across
    boundaries: pinned on a card (plain on the CPU), grown to the next
    power of two of the rows asked for. A pinned buffer must not be
    rewritten while a copy from it is in flight, so :meth:`take` waits
    on the event :meth:`sent` recorded after the last such copy."""

    def __init__(self, templates, pinned: bool):
        self.templates = templates           # [(row shape, dtype)]
        self.pinned = pinned
        self.bufs: list = []
        self.rows = 0
        self.event = None

    def take(self, n: int) -> list:
        """Views of ``n`` rows of each buffer, safe to overwrite."""
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        if n > self.rows:
            self.rows = next_pow2(n)
            self.bufs = [torch.empty((self.rows,) + tuple(shape), dtype=dt,
                                     pin_memory=self.pinned)
                         for shape, dt in self.templates]
        return [b[:n] for b in self.bufs]

    def sent(self, stream) -> None:
        """A copy from the buffers was queued on ``stream``."""
        if self.pinned:
            self.event = torch.cuda.Event()
            self.event.record(stream)


# ---------------------------------------------------------------------------
# Trees of tensors: nested dicts and lists (the training path's
# parameters, gradients and optimizer moments)
# ---------------------------------------------------------------------------
def as_tree(x):
    """A module tree of parameters (``nn.ParameterDict``,
    ``nn.ModuleDict``, ``nn.ModuleList``) -> the same nesting of dicts
    and lists over its parameters; a dict or list tree is mapped the
    same way, a leaf returned as it is."""
    if isinstance(x, (dict, torch.nn.ParameterDict, torch.nn.ModuleDict)):
        return {k: as_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, torch.nn.ModuleList)):
        return [as_tree(v) for v in x]
    return x


def tree_leaves(tree) -> list:
    """The leaves of a dict / list tree, depth first in key order (a
    tuple is a leaf)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of the
    trees in ``rest`` (only ``tree``'s structure is walked, so a subtree
    of ``rest`` where ``tree`` has a leaf is passed whole)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


# ---------------------------------------------------------------------------
# Visited-set bloom filter (the "query property table" visited bits).
# Two multiplicative hashes; false positives only *skip* re-expansion of a
# vertex, never corrupt returned distances.
# ---------------------------------------------------------------------------
_H1 = 0x9E3779B1
_H2 = 0x85EBCA77
_U32 = 0xFFFFFFFF


def _mul_u32(u: torch.Tensor, c: int) -> torch.Tensor:
    """(u * c) mod 2**32 for int64 ``u`` in [0, 2**32), without int64
    overflow: c splits into 16-bit halves, so no product exceeds 2**48."""
    hi = ((u * (c >> 16)) & 0xFFFF) << 16
    return (hi + u * (c & 0xFFFF)) & _U32


def bloom_hashes(ids: torch.Tensor, num_bits: int):
    """Two hash positions in [0, num_bits) per id (int64). num_bits = 2**k.

    The reference's uint32 arithmetic, carried in int64: ids reinterpret
    as uint32 (``-1`` -> 0xFFFFFFFF) and every product wraps mod 2**32.
    """
    u = ids.to(torch.int64) & _U32
    h1 = _mul_u32(u, _H1) >> 7
    h2 = _mul_u32((u + 1) & _U32, _H2) >> 5
    mask = num_bits - 1
    return h1 & mask, h2 & mask


def bloom_insert(bloom: torch.Tensor, ids: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """bloom: (..., num_bits) bool; ids/valid: (..., n). Returns a new map."""
    nb = bloom.shape[-1]
    p1, p2 = bloom_hashes(ids, nb)
    v = torch.cat([valid, valid], dim=-1)
    # masked ids write into a spill column that is sliced off
    pos = torch.where(v, torch.cat([p1, p2], dim=-1), nb)
    ext = torch.cat([bloom, bloom.new_zeros(bloom.shape[:-1] + (1,))], dim=-1)
    return ext.scatter_(-1, pos, True)[..., :nb]


def bloom_query(bloom: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Returns bool (..., n): True if id *possibly* visited."""
    p1, p2 = bloom_hashes(ids, bloom.shape[-1])
    return bloom.gather(-1, p1) & bloom.gather(-1, p2)


def bloom_pack(bloom: torch.Tensor) -> torch.Tensor:
    """(..., num_bits) bool map -> (..., num_bits // 32) int64 holding the
    reference's uint32 words (bit b of word w is map position 32*w + b)."""
    bits = bloom.reshape(bloom.shape[:-1] + (-1, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bloom.device) << \
        torch.arange(32, device=bloom.device)
    return (bits * weights).sum(-1)
