"""Trace-discipline analysis suite of the port.

Three layers, one discipline: the host stays off the critical path, and
a captured chunk replays what was captured.

- ``analysis.lint`` (layer 1): AST linter with the rules NDS001-NDS005
  re-expressed for torch: host/device mixing, Python branches on tensors
  in capture-reachable code (baked into a CUDA graph at capture),
  implicit syncs in hot-path modules, device math in host-only modules,
  mutable static keys and defaults.
- ``analysis.op_audit`` (layer 2): runs every chunk program once under a
  recording dispatch mode and checks its op stream (no sync op, no
  float64, the frame install in place) against a committed op
  histogram, ``audit_baseline.json``.
- ``analysis.capture_guard`` (layer 3): ``CaptureGuard``, counting the
  chunk programs ``core.capture.CACHE`` builds, to machine-check that
  one capture covers a whole serving session.

CLI: ``python -m repro_torch.analysis lint src/repro_torch`` and
``python -m repro_torch.analysis audit [--device cpu]`` (a card by
default). Both baselines live beside
this package.

Layer 1 imports no torch, so linting stays fast.
"""

__all__ = ["lint", "op_audit", "capture_guard"]
