"""Layer 3: count the chunk programs a session builds.

The serving claim is that one build covers every dispatch: ring
restaging, page-store residency swaps, epoch swaps and fault plans all
replay the one ``engine_run_chunk_admit`` entry of the session, so the
host never pays a capture on the critical path. ``CaptureGuard`` turns
that claim into a machine check: it listens on the process's
``core.capture.CACHE`` and records the program name of every entry the
cache builds while the guard is open. On a card a build is a CUDA-graph
capture; on the CPU it is the eager entry the same key makes.

Cache *hits* record nothing, so a guarded region that builds nothing
records nothing -- which is exactly the property to assert. Names are
program names (``engine_run_chunk_admit``, ``search_sim``, ...), so
callers filter with ``count("engine_run_chunk_admit")``.

Usage::

    with CaptureGuard() as cg:
        ids, dists, stats = stream_search(...)
    assert cg.count("engine_run_chunk_admit") == 1

or enforcing inline::

    with CaptureGuard(match="engine_run_chunk", max_captures=1):
        ...
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.capture import CACHE


class CaptureGuard:
    """Context manager recording every chunk-program build by name.

    Parameters
    ----------
    match:
        Optional substring; when given together with ``max_captures``,
        only matching program names count against the limit.
    max_captures:
        When set, exiting the context raises ``RuntimeError`` if more
        than this many (matching) builds were observed. The check is
        skipped when the body is already raising, so it never masks the
        original error.
    """

    def __init__(self, match: Optional[str] = None,
                 max_captures: Optional[int] = None):
        self.match = match
        self.max_captures = max_captures
        self.names: list = []

    def count(self, substring: Optional[str] = None) -> int:
        """Number of recorded builds whose name contains substring."""
        if substring is None:
            return len(self.names)
        return sum(1 for n in self.names if substring in n)

    @property
    def total(self) -> int:
        return len(self.names)

    def __enter__(self):
        CACHE.listeners.append(self.names.append)
        return self

    def __exit__(self, exc_type, exc, tb):
        CACHE.listeners.remove(self.names.append)
        if exc_type is None and self.max_captures is not None:
            n = self.count(self.match)
            if n > self.max_captures:
                matching = [x for x in self.names
                            if self.match is None or self.match in x]
                raise RuntimeError(
                    f"CaptureGuard: {n} capture(s) observed "
                    f"(limit {self.max_captures}"
                    + (f", match={self.match!r}" if self.match else "")
                    + f"): {matching}")
        return False
