"""Restart supervisor: checkpoint/restore-based fault tolerance (the
reference's ``ft/restart.py``, over the port's checkpoint module).

``run_with_restarts`` drives a step function and treats any raised
exception as a node/process failure: it restores the latest committed
checkpoint and resumes. Combined with the deterministic, step-addressed
data pipeline (data/pipeline.py) the recovered run replays the exact
stream of the crashed one.

Checkpoint cadence bounds the work a failure loses to one interval; a
restart may restore onto another device (``checkpoint.restore``'s
``device``), the port's stand-in for the reference's elastic re-shard.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

from repro_torch import checkpoint as ckpt

log = logging.getLogger(__name__)


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    steps_replayed: int = 0
    skipped_steps: int = 0
    backoff_s: float = 0.0    # total seconds slept backing off between
                              # restarts (exponential, jittered)


def _backoff(attempt: int, base: float, cap: float,
             jitter: float) -> float:
    """Exponential backoff with deterministic jitter: base * 2^(a-1)
    capped at ``cap``, then scaled by a per-attempt factor in
    [1 - jitter, 1 + jitter].  The jitter is a pure function of the
    attempt number (golden-ratio low-discrepancy sequence), so restart
    schedules are reproducible yet de-synchronized across attempts —
    the thundering-herd fix without an RNG dependency."""
    wait = min(base * (2.0 ** (attempt - 1)), cap)
    frac = (attempt * 0.6180339887498949) % 1.0
    return wait * (1.0 + jitter * (2.0 * frac - 1.0))


def run_with_restarts(
    *,
    init_state: Callable[[], tuple],        # () -> (step, state)
    restore_state: Callable[[int], tuple],  # ckpt step -> (step, state)
    run_step: Callable[[int, tuple], tuple],  # (step, state) -> state
    save_state: Callable[[int, tuple], None],
    total_steps: int,
    ckpt_dir: str,
    ckpt_every: int = 50,
    max_restarts: int = 3,
    fail_injector: Optional[Callable[[int], None]] = None,
    backoff_base: float = 0.01,
    backoff_max: float = 1.0,
    backoff_jitter: float = 0.25,
    sleep_fn: Callable[[float], None] = time.sleep,
) -> tuple:
    """Supervised training loop. ``fail_injector(step)`` may raise to
    simulate a node failure (used by the fault-tolerance tests).

    Consecutive failures back off exponentially (``backoff_base`` * 2^n
    up to ``backoff_max`` seconds, ±``backoff_jitter`` deterministic
    jitter) before touching the checkpoint store again — an unhealthy
    store or a crash-looping step shouldn't be hammered at full rate.
    ``sleep_fn`` is injectable so tests assert the schedule without
    sleeping."""
    stats = RestartStats()
    latest = ckpt.latest_step(ckpt_dir)
    if latest is not None:
        step, state = restore_state(latest)
        log.info("resuming from step %d", step)
    else:
        step, state = init_state()

    while step < total_steps:
        try:
            if fail_injector is not None:
                fail_injector(step)
            state = run_step(step, state)
            step += 1
            if step % ckpt_every == 0 or step == total_steps:
                save_state(step, state)
        except KeyboardInterrupt:
            raise
        except Exception as e:  # noqa: BLE001 — any failure => restart
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts") from e
            wait = _backoff(stats.restarts, backoff_base, backoff_max,
                            backoff_jitter)
            log.warning("step %d failed (%s); restart %d/%d after "
                        "%.3fs backoff", step, e, stats.restarts,
                        max_restarts, wait)
            sleep_fn(wait)
            stats.backoff_s += wait
            latest = ckpt.latest_step(ckpt_dir)
            if latest is None:
                step, state = init_state()
            else:
                prev = step
                step, state = restore_state(latest)
                stats.steps_replayed += max(prev - step, 0)
    return step, state, stats
