"""Small shared utilities: sentinels, shape math, device choice, and the
visited-set bloom filter.

The bloom keeps the reference's two multiplicative hashes bit for bit,
but stores its bits as a boolean map ``(..., num_bits)`` instead of
packed uint32 words: torch has no ``>>`` on uint32 tensors on the CPU,
and setting a bit is then a plain scatter of ``True`` (colliding writes
all write the same value, so they need no OR-reduction).
:func:`bloom_pack` folds a map into the reference's uint32 words.
"""
from __future__ import annotations

import math

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
