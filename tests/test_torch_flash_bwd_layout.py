"""The flash backward's band layout on the CPU, against the plain
version's mask.

The backward's first kernel writes P and dS for the kv tiles of
``BAND_K`` columns that ``band_layout`` gives each q tile of ``BAND_Q``
rows; its second kernel sums, for each kv tile of 32 rows, the q tiles
whose ``live_cols`` interval meets it. Both kernels compute those
intervals with the same formula. Here, for a grid of shapes (gemma3-1b's
local and global layers, a ragged last kv tile, s_orig below Skv, a
window past s_orig), every pair that ``ref._mask`` marks live lies in
exactly one band tile, no band tile is entirely masked, the second
kernel's q tiles are exactly those with a live pair in its columns, and
``band_plan`` sizes the scratch that the wrapper allocates, sliced over
(batch, kv head) pairs above the budget. Pure Python and torch.
"""
import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ref import _mask

KV2 = 32    # kv rows of the second kernel's tile

CASES = [
    # S, Skv, causal, window, s_orig
    (1024, 1024, True, 512, 1024),     # gemma3-1b local layer
    (1024, 1024, True, 0, 1024),       # gemma3-1b global layer
    (992, 992, True, 40, 992),         # a ragged last kv tile of 64
    (160, 224, False, 0, 200),
    (160, 224, True, 0, 200),
    (1024, 1088, False, 0, 1000),      # seamless cross, kv_valid 1000
    (320, 224, False, 40, 200),        # q tiles past s_orig + window
    (512, 512, True, 100, 512),
    (64, 256, True, 0, 256),
    (256, 64, False, 17, 64),
    (96, 96, True, 0, 96),
]


def _tiles(mask, rows: int, cols: int):
    """(S / rows, ceil(Skv / cols)) bool: the tiles holding a live pair."""
    S, Skv = mask.shape
    pad = -Skv % cols
    m = torch.nn.functional.pad(mask, (0, pad))
    return m.reshape(S // rows, rows, -1, cols).any(3).any(1)


@pytest.mark.parametrize("S,Skv,causal,window,s_orig", CASES)
def test_band_covers_the_mask(S, Skv, causal, window, s_orig):
    mask = _mask(S, Skv, "cpu", causal=causal, window=window,
                 s_orig=s_orig).expand(S, Skv)
    kw = dict(causal=causal, window=window)
    # each q tile's interval is its live columns, first to last
    for i in range(S // fk.BAND_Q):
        lo, hi = fk.live_cols(i * fk.BAND_Q, s_orig, **kw)
        cols = mask[i * fk.BAND_Q:(i + 1) * fk.BAND_Q].any(0).nonzero()
        if len(cols):
            assert (lo, hi) == (int(cols[0]), int(cols[-1]))
            assert bool(mask[i * fk.BAND_Q:(i + 1) * fk.BAND_Q,
                             lo:hi + 1].any(0).all())
        else:
            assert lo > hi
    # the band's tiles are the tiles with a live pair: each live pair in
    # exactly one, none entirely masked
    live = _tiles(mask, fk.BAND_Q, fk.BAND_K)
    band = torch.zeros_like(live)
    for i, (lo, n) in enumerate(fk.band_layout(S, s_orig=s_orig, **kw)):
        band[i, lo:lo + n] = True
    assert torch.equal(band, live)
    # the second kernel's q tiles for each kv tile of 32 rows: an
    # interval, exactly the q tiles with a live pair in its columns
    live2 = _tiles(mask, fk.BAND_Q, KV2)
    for jt in range(Skv // KV2):
        k0 = jt * KV2
        hit = [lo <= hi and lo < k0 + KV2 and k0 <= hi
               for lo, hi in (fk.live_cols(i * fk.BAND_Q, s_orig, **kw)
                              for i in range(S // fk.BAND_Q))]
        assert hit == live2[:, jt].tolist()
        idx = [i for i, h in enumerate(hit) if h]
        if idx:
            assert idx == list(range(idx[0], idx[-1] + 1))


@pytest.mark.parametrize("budget", [None, 1, 40 << 20])
@pytest.mark.parametrize("S,Skv,causal,window,s_orig", CASES[:3])
def test_band_plan_sizes_the_scratch(monkeypatch, budget, S, Skv, causal,
                                     window, s_orig):
    """gemma3-1b's training shape (B 4, H 4, Hkv 1) and a GQA one: the
    width is the most live kv tiles of a q tile, a pass's scratch fits the
    budget (or holds one pair), and the passes cover every pair."""
    if budget is not None:
        monkeypatch.setattr(fk, "BAND_BUDGET", budget)
    kw = dict(causal=causal, window=window, s_orig=s_orig)
    width = max(n for _, n in fk.band_layout(S, **kw))
    for B, H, Hkv in ((4, 4, 1), (2, 8, 2)):
        w, per_pass, numel = fk.band_plan(B, H, Hkv, S, **kw)
        per_bh = (H // Hkv) * (S // fk.BAND_Q) * width * fk.BAND_Q * \
            fk.BAND_K
        assert w == width and numel == per_pass * per_bh
        assert 1 <= per_pass <= B * Hkv
        if per_pass > 1:
            assert 2 * 4 * numel <= fk.BAND_BUDGET
        if per_pass < B * Hkv:
            assert 2 * 4 * (per_pass + 1) * per_bh > fk.BAND_BUDGET
        passes = [(b0, min(per_pass, B * Hkv - b0))
                  for b0 in range(0, B * Hkv, per_pass)]
        assert sum(n for _, n in passes) == B * Hkv
        if budget == 1:
            assert per_pass == 1 and len(passes) == B * Hkv
        if budget is None:      # one pass at these shapes
            assert per_pass == B * Hkv
    if (S, window) == (1024, 512):
        assert width == 9
    if (S, window) == (1024, 0):
        assert width == 16
