"""Deterministic fault injection for the serving path.

A :class:`FaultSpec` is a *plan*, not a random process: every fault is
pinned to a shard and a round (or, for corruption, a seeded hash of the
physical page), so a chaos run is exactly reproducible and the engine
evaluates the plan inside its round chunks with no host reads.

Three fault classes, mirroring how computational-storage serving breaks
(NDSEARCH §V runs many independent SSD/LUN pipelines):

* **kill**: shard ``s`` stops serving at global round ``r`` and never
  comes back — its slot rows do no phase work from that round on (the
  scheduler's per-query deadline is what retires them).
* **delay**: shard ``s`` stalls for ``d`` rounds starting at round
  ``r`` — a transient straggler; rows resume afterwards with their
  traversal state intact.
* **corrupt**: a deterministic pseudo-random fraction of physical page
  reads returns garbage distances (NaN or a huge negative) — flipped
  bits or failed ECC on the medium. The corruption guard
  (``EngineParams.guard_nonfinite``) quarantines these to ``BIG_DIST``
  and counts them instead of letting them poison the bitonic merge.

The spec rides on :class:`repro_torch.core.engine.EngineParams`, part
of the capture cache's key, so it must stay hashable — per-shard
schedules are tuples, never tensors, and each plan is its own captured
program. ``faults=None`` (the default) adds no op: every injection site
is gated on the host on the spec.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.utils import _mul_u32

#: sentinel round for "never" — beyond any reachable serving clock
NEVER = 2**31 - 1
_U32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """A deterministic, seedable fault plan (hashable)."""

    num_shards: int
    kill_round: tuple = ()      # per-shard global round of death (NEVER
                                # = healthy forever)
    delay_from: tuple = ()      # per-shard stall window start (NEVER =
                                # no stall)
    delay_rounds: tuple = ()    # per-shard stall window length
    corrupt_rate: float = 0.0   # fraction of page reads corrupted
    corrupt_mode: str = "nan"   # "nan" | "neg" (huge negative distance)
    seed: int = 0               # corruption hash salt

    def __post_init__(self):
        S = self.num_shards
        if not self.kill_round:
            object.__setattr__(self, "kill_round", (NEVER,) * S)
        if not self.delay_from:
            object.__setattr__(self, "delay_from", (NEVER,) * S)
        if not self.delay_rounds:
            object.__setattr__(self, "delay_rounds", (0,) * S)
        for name in ("kill_round", "delay_from", "delay_rounds"):
            if len(getattr(self, name)) != S:
                raise ValueError(f"{name} must have num_shards={S} "
                                 f"entries, got {getattr(self, name)}")
        if self.corrupt_mode not in ("nan", "neg"):
            raise ValueError(f"corrupt_mode must be 'nan' or 'neg', "
                             f"got {self.corrupt_mode!r}")
        if not 0.0 <= self.corrupt_rate <= 1.0:
            raise ValueError(f"corrupt_rate must be in [0, 1], got "
                             f"{self.corrupt_rate}")

    # -- plan builders (each returns a new frozen spec) ---------------------
    def kill(self, shard: int, at_round: int) -> "FaultSpec":
        """Shard ``shard`` dies at global round ``at_round``."""
        kr = list(self.kill_round)
        kr[shard] = int(at_round)
        return dataclasses.replace(self, kill_round=tuple(kr))

    def delay(self, shard: int, at_round: int, rounds: int) -> "FaultSpec":
        """Shard ``shard`` stalls for ``rounds`` rounds from
        ``at_round``."""
        df = list(self.delay_from)
        dr = list(self.delay_rounds)
        df[shard] = int(at_round)
        dr[shard] = int(rounds)
        return dataclasses.replace(self, delay_from=tuple(df),
                                   delay_rounds=tuple(dr))

    def corrupt(self, rate: float, mode: str = "nan",
                seed: int = 0) -> "FaultSpec":
        """A deterministic ``rate`` fraction of page reads returns
        garbage (``mode``: NaN or huge-negative) under hash salt
        ``seed``."""
        return dataclasses.replace(self, corrupt_rate=float(rate),
                                   corrupt_mode=mode, seed=int(seed))

    # -- host-side predicates (gate the injection sites) --------------------
    @property
    def any_stall(self) -> bool:
        return (any(k != NEVER for k in self.kill_round)
                or any(f != NEVER and r > 0
                       for f, r in zip(self.delay_from,
                                       self.delay_rounds)))

    @property
    def any_kill(self) -> bool:
        return any(k != NEVER for k in self.kill_round)

    @property
    def any_corrupt(self) -> bool:
        return self.corrupt_rate > 0.0

    def down_at(self, t: int) -> np.ndarray:
        """(S,) bool — shards dead (killed, not merely delayed) by
        global round ``t``. Host-side planning helper."""
        return np.asarray(self.kill_round, np.int64) <= int(t)


def fault_plan(num_shards: int) -> FaultSpec:
    """An empty (all-healthy) plan to chain builders off."""
    return FaultSpec(num_shards=num_shards)


def parse_fault_args(num_shards: int, kill=None, delay=None,
                     corrupt_rate: float = 0.0,
                     corrupt_mode: str = "nan",
                     seed: int = 0) -> FaultSpec | None:
    """Build a plan from CLI-style strings — ``kill`` entries are
    ``"shard:round"``, ``delay`` entries ``"shard:round:rounds"`` —
    returning None (the no-faults path) when every knob is at rest.
    Shared by the serving CLIs."""
    spec = fault_plan(num_shards)
    for item in kill or []:
        s, r = (int(x) for x in str(item).split(":"))
        spec = spec.kill(s, r)
    for item in delay or []:
        s, r, d = (int(x) for x in str(item).split(":"))
        spec = spec.delay(s, r, d)
    if corrupt_rate > 0:
        spec = spec.corrupt(corrupt_rate, corrupt_mode, seed)
    if spec.any_stall or spec.any_corrupt:
        return spec
    return None


# ---------------------------------------------------------------------------
# device evaluation — called inside the engine's round chunks
# ---------------------------------------------------------------------------
def _table(values: tuple, rest: int, device) -> torch.Tensor:
    """A per-shard schedule as an (S,) int32 tensor built by fills, not
    copied from host memory (a copy would break a CUDA graph capture):
    ``rest`` everywhere, then each shard that differs."""
    out = torch.full((len(values),), rest, dtype=torch.int32, device=device)
    for s, v in enumerate(values):
        if v != rest:
            out.narrow(0, s, 1).fill_(v)
    return out


def stall_at(spec: FaultSpec, t) -> torch.Tensor:
    """(S,) bool — shards not serving at global round ``t`` (a 0-d int32
    tensor, or a host int): killed for good, or inside a delay window."""
    t = torch.as_tensor(t, dtype=torch.int32)
    kill = _table(spec.kill_round, NEVER, t.device)
    dfrom = _table(spec.delay_from, NEVER, t.device)
    dlen = _table(spec.delay_rounds, 0, t.device)
    return (t >= kill) | ((t >= dfrom) & (t < dfrom + dlen))


def bad_page_mask(spec: FaultSpec, ppage: torch.Tensor, shard
                  ) -> torch.Tensor:
    """Deterministic per-(page, shard, seed) corruption mask: an integer
    avalanche hash of the physical page id, salted by the owning shard
    and the plan seed, thresholded at ``corrupt_rate`` — the same page
    read corrupts on every visit, like real media damage. ``shard`` is a
    host int or an int tensor broadcastable against ``ppage`` (the
    shard-batched engine passes ``arange(S)[:, None]``).

    The reference's uint32 arithmetic, carried in int64: every operand
    is reinterpreted as uint32, every product wraps mod 2**32
    (``utils._mul_u32``, no int64 overflow), and each shift acts on a
    value already masked to 32 bits."""
    u = ppage.to(torch.int64) & _U32
    s = (torch.as_tensor(shard, device=ppage.device).to(torch.int64)
         + 1) & _U32
    h = (_mul_u32(u, 2654435761) ^ _mul_u32(s, 0x9E3779B9)
         ^ ((spec.seed * 0x85EBCA6B) & _U32))
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return h < min(int(spec.corrupt_rate * float(2**32)), 2**32 - 1)


def corrupt_value(spec: FaultSpec) -> float:
    """The garbage distance a corrupted read returns."""
    return float("nan") if spec.corrupt_mode == "nan" else -3.0e38
