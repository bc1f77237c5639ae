"""Deterministic synthetic data pipelines (the port's own copy of the
reference's ``data/pipeline.py``, numpy only: the same batches bit for
bit).

Every batch is a pure function of (seed, step) — restart/resume replays
the exact stream with no iterator state to checkpoint (the fault-
tolerance story depends on this: a restore at step k continues with the
same batch k+1 the crashed run would have seen).

The LM task is learnable (so training-loss-decreases tests are
meaningful): tokens follow per-sequence affine recurrences
x_{t+1} = (a*x_t + c) mod V with a small regime-switch every 64 tokens;
a model reduces loss by inferring (a, c) in context.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    regime: int = 64              # tokens between (a, c) switches

    def batch_at(self, step: int) -> dict:
        """{tokens (B,S) i32, labels (B,S) i32} for this step."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len, self.vocab_size
        n_reg = -(-S // self.regime) + 1
        a = rng.integers(1, max(V - 1, 2), size=(B, n_reg), dtype=np.int64)
        c = rng.integers(0, V, size=(B, n_reg), dtype=np.int64)
        x = rng.integers(0, V, size=(B,), dtype=np.int64)
        toks = np.empty((B, S + 1), dtype=np.int64)
        toks[:, 0] = x
        for t in range(S):
            r = t // self.regime
            x = (a[:, r] * x + c[:, r]) % V
            toks[:, t + 1] = x
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def host_slice(self, step: int, process_index: int, num_processes: int):
        """This host's rows of the global batch (multi-host feeding)."""
        batch = self.batch_at(step)
        per = self.global_batch // num_processes
        sl = slice(process_index * per, (process_index + 1) * per)
        return {k: v[sl] for k, v in batch.items()}


@dataclasses.dataclass(frozen=True)
class FrontendPipeline:
    """Deterministic embedding stand-ins for the vlm/audio frontends."""
    d_model: int
    tokens: int                  # frontend positions per example
    seed: int = 0

    def batch_at(self, step: int, batch: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed + 7, step]))
        x = rng.standard_normal((batch, self.tokens, self.d_model),
                                dtype=np.float32)
        return x * 0.05
