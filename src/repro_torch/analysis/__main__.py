"""CLI for the port's trace-discipline suite.

  python -m repro_torch.analysis lint src/repro_torch           # layer 1
  python -m repro_torch.analysis audit                          # layer 2, a card
  python -m repro_torch.analysis audit --device cpu             # layer 2, CPU
  python -m repro_torch.analysis audit --device cpu --update    # refresh snapshot

The baselines are found beside this package: ``lint_baseline.json`` for
lint suppressions, ``audit_baseline.json`` for the op histograms.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
LINT_BASELINE = HERE / "lint_baseline.json"
AUDIT_BASELINE = HERE / "audit_baseline.json"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="trace-discipline lint / op audit")
    sub = p.add_subparsers(dest="cmd", required=True)

    lp = sub.add_parser("lint", help="AST lint (NDS001-NDS005)")
    lp.add_argument("paths", nargs="+")
    lp.add_argument("--baseline", default=str(LINT_BASELINE),
                    help="suppression baseline (default: %(default)s)")
    lp.add_argument("--no-baseline", action="store_true",
                    help="show all findings, ignoring the baseline")

    ap = sub.add_parser("audit", help="op-stream audit of the chunk "
                                      "programs")
    ap.add_argument("--baseline", default=str(AUDIT_BASELINE),
                    help="snapshot baseline (default: %(default)s)")
    ap.add_argument("--update", action="store_true",
                    help="rewrite this torch version's snapshot")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"),
                    help="cuda (default): the kernels, launches per round "
                         "checked; cpu: plain kernel versions, histograms "
                         "compared")

    args = p.parse_args(argv)
    if args.cmd == "lint":
        from repro_torch.analysis.lint import run_lint
        return run_lint(args.paths, baseline_path=args.baseline,
                        show_all=args.no_baseline)
    from repro_torch.analysis.op_audit import run_audit
    return run_audit(args.baseline, update=args.update, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
