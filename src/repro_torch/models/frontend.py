"""Modality frontend STUBS (the reference's ``models/frontend.py`` in
torch): the [audio]/[vlm] configurations specify the transformer
backbone only, so the frame and patch embeddings arrive precomputed.

The stubs draw from an explicit ``torch.Generator`` (on its device), so
runs are reproducible from a seed. The two packages' generators give
different numbers from one seed: the tests hand both the same numpy
inputs instead. ``launch/serve.py`` takes only ``frontend_shape`` from
here and draws plain 0.05-scaled normals of that shape, as the
reference's serve driver does; ``vision_stub`` and ``audio_stub`` are
reached by the tests alone.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig

# llava-next anyres tiling: 4 high-res tiles + 1 base view, 576 patches each
VISION_TILES = 5
VISION_PATCHES_PER_TILE = 576
# seamless fbank frontend: 80-dim mel frames, stride-2 conv downsample (stub)
AUDIO_FRAME_STRIDE = 2


def frontend_shape(cfg: ArchConfig, batch: int, seq_len: int):
    """Shape of the precomputed embedding tensor the stub supplies."""
    if cfg.frontend == "vision":
        return (batch, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "audio":
        # encoder input: one embedding per (downsampled) fbank frame
        return (batch, seq_len, cfg.d_model)
    return None


def vision_stub(cfg: ArchConfig, batch: int,
                gen: torch.Generator) -> torch.Tensor:
    """Precomputed anyres patch embeddings (B, frontend_tokens, d)."""
    if cfg.frontend != "vision":
        raise ValueError(f"{cfg.name} has no vision frontend")
    f = cfg.frontend_tokens
    x = torch.randn((batch, f, cfg.d_model), generator=gen,
                    device=gen.device)
    # tile-position offset so the 5 anyres views are distinguishable
    tiles = max(f // VISION_PATCHES_PER_TILE, 1)
    tile_id = torch.arange(f, device=gen.device) // max(f // tiles, 1)
    return x + 0.1 * tile_id[None, :, None].float()


def audio_stub(cfg: ArchConfig, batch: int, frames: int,
               gen: torch.Generator) -> torch.Tensor:
    """Precomputed fbank-frame embeddings (B, frames, d)."""
    if cfg.frontend != "audio":
        raise ValueError(f"{cfg.name} has no audio frontend")
    x = torch.randn((batch, frames, cfg.d_model), generator=gen,
                    device=gen.device)
    # smooth over time like a conv frontend would
    return 0.5 * (x + torch.roll(x, 1, dims=1))
