"""The port's trace-discipline suite (repro_torch/analysis/), case for
case the twin of tests/test_analysis.py: lint rule fixtures (positive
and clean per rule, written for torch), the static-key case, the
committed tree and its baseline, seeded violations in a copy of the
port's scheduler; the op audit against its committed histograms, no
sync op and no float64 on any chunk program, the frame install in
place; ``CaptureGuard`` counting builds and its limit. Its serving
sessions (one build per session) are in
tests/test_torch_analysis_sessions.py."""
import io
import json
import shutil
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.capture_guard import CaptureGuard
from repro_torch.analysis.lint import (apply_baseline, lint_paths,
                                       load_baseline, run_lint)
from repro_torch.core.capture import CACHE

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"
LINT_BASELINE = PKG / "analysis" / "lint_baseline.json"
AUDIT_BASELINE = PKG / "analysis" / "audit_baseline.json"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores (integer arithmetic is exact at any thread count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# Layer 1: rule fixtures. Each rule gets a module with a known violation
# and a clean twin; the linter must flag exactly the former.
# ---------------------------------------------------------------------------
FIXTURES = {
    "NDS001": (
        """
        # nds: hot-path-module
        import numpy as np
        import torch
        SENTINEL = torch.full((), 2**31 - 1, dtype=torch.int32,
                              device="cuda")

        def predictor(cands):
            host = np.asarray(cands)
            return host != SENTINEL      # a device const in host math
        """,
        """
        # nds: hot-path-module
        import numpy as np
        import torch
        SENTINEL = torch.full((), 2**31 - 1, dtype=torch.int32,
                              device="cuda")
        _SENT = 2**31 - 1

        def predictor(cands):
            host = np.asarray(cands)
            return host != _SENT
        """),
    "NDS002": (
        """
        import torch
        from repro_torch.core.capture import CACHE

        def step(x):
            if x.sum() > 0:              # baked in at capture
                return x
            return -x

        def run(x):
            return CACHE.run("step", step, (), (x,), 1)
        """,
        """
        import torch
        from repro_torch.core.capture import CACHE

        def step(x):
            return torch.where(x.sum() > 0, x, -x)

        def run(x):
            return CACHE.run("step", step, (), (x,), 1)
        """),
    "NDS003": (
        """
        # nds: hot-path-module
        import torch

        def boundary(state):
            total = torch.sum(state)
            return float(total)          # hidden device sync
        """,
        """
        # nds: hot-path-module
        import torch
        from repro_torch.utils import to_host

        def boundary(state):
            total = torch.sum(state)
            return float(to_host(total)[0])   # explicit, sanctioned
        """),
    "NDS004": (
        """
        # nds: host-only-module
        import torch

        def summarize(xs):
            return torch.mean(torch.as_tensor(xs))
        """,
        """
        # nds: host-only-module
        import numpy as np

        def summarize(xs):
            return np.mean(np.asarray(xs))
        """),
    "NDS005": (
        """
        import torch

        def step(x, pad=[0.0]):  # nds: captured
            return x
        """,
        """
        import torch

        def step(x, pad=(0.0,)):  # nds: captured
            return x
        """),
}


def _write_module(tmp_path, name, body):
    f = tmp_path / f"{name}.py"
    f.write_text(textwrap.dedent(body))
    return f


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_fires_on_violation(tmp_path, rule):
    bad = _write_module(tmp_path, f"bad_{rule.lower()}", FIXTURES[rule][0])
    findings = lint_paths([bad])
    assert [f.rule for f in findings].count(rule) >= 1, \
        f"{rule} did not fire: {[f.render() for f in findings]}"


@pytest.mark.parametrize("rule", sorted(FIXTURES))
def test_rule_quiet_on_clean_twin(tmp_path, rule):
    good = _write_module(tmp_path, f"good_{rule.lower()}", FIXTURES[rule][1])
    findings = lint_paths([good])
    assert findings == [], [f.render() for f in findings]


@pytest.mark.parametrize("key", ["key", '{"w": widths}'])
def test_nds005_mutable_static_key(tmp_path, key):
    """The twin of the reference's static-name case: a static_key that
    holds a mutable literal, through a name or passed inline."""
    f = _write_module(tmp_path, "bad_statickey", f"""
        from repro_torch.core.capture import CACHE

        def step(x):
            return x

        def run(x, widths):
            key = ("step", [w for w in widths])
            return CACHE.run("step", step, {key}, (x,), 1)
        """)
    findings = lint_paths([f])
    assert any(x.rule == "NDS005" and x.func == "run" for x in findings), \
        [x.render() for x in findings]


def test_host_branch_on_a_tuple_of_tensors_is_not_a_sync(tmp_path):
    """A tuple's truth is its length: branching on a tuple of tensors
    (the scheduler's boundary does) reads nothing from the device."""
    f = _write_module(tmp_path, "tuple_truth", """
        # nds: hot-path-module
        import torch

        def boundary(st, tiered, steps):
            tier = () if not tiered else (torch.zeros(3, device="cuda"),)
            if tier and steps:
                return 1
            return 0
        """)
    assert lint_paths([f]) == []


# ---------------------------------------------------------------------------
# The committed tree + the committed suppression baseline
# ---------------------------------------------------------------------------
def test_committed_tree_is_clean():
    out = io.StringIO()
    code = run_lint([PKG], baseline_path=LINT_BASELINE, out=out)
    assert code == 0, out.getvalue()
    assert "stale baseline entry" not in out.getvalue(), out.getvalue()


def test_cli_lint_and_no_baseline():
    from repro_torch.analysis.__main__ import main
    assert main(["lint", str(PKG)]) == 0
    assert main(["lint", str(PKG), "--no-baseline"]) == 1


def test_baseline_entries_require_justification(tmp_path):
    b = tmp_path / "baseline.json"
    b.write_text(json.dumps({"suppressions": [
        {"file": "repro_torch/core/scheduler.py", "rule": "NDS003",
         "func": "f", "text": "x = int(y)", "why": ""}]}))
    with pytest.raises(ValueError, match="justification"):
        load_baseline(b)
    for e in json.loads(LINT_BASELINE.read_text())["suppressions"]:
        assert e["why"].strip(), e


def test_baseline_suppresses_matching_finding(tmp_path):
    bad = _write_module(tmp_path, "bad_nds004", FIXTURES["NDS004"][0])
    findings = lint_paths([bad])
    assert findings
    f = findings[0]
    baseline = {f.suppression_key: {"why": "fixture"}}
    active, suppressed, stale = apply_baseline(findings, baseline)
    assert suppressed and not stale
    assert all(x.suppression_key != f.suppression_key for x in active)


# Seeding any one rule violation into core/scheduler.py must turn the
# committed-tree lint red (the acceptance gate for the whole layer).
SEEDS = {
    "NDS001": """
def _seeded_nds001(arr, dev):
    return np.asarray(arr) == torch.full((), ID_SENTINEL, device=dev)
""",
    "NDS002": """
def _seeded_nds002(x):  # nds: captured
    if x.sum() > 0:
        return x + 1
    return x - 1
""",
    "NDS003": """
def _seeded_nds003(state):
    return float(torch.sum(state))
""",
    "NDS004": """
def _seeded_nds004(n):  # nds: host-only
    return torch.arange(n)
""",
    "NDS005": """
def _seeded_nds005(x, pad=[0.0]):  # nds: captured
    return x
""",
}


@pytest.mark.parametrize("rule", sorted(SEEDS))
def test_seeded_violation_fails_lint(tmp_path, rule):
    tree = tmp_path / "repro_torch"
    shutil.copytree(PKG, tree,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    sched = tree / "core" / "scheduler.py"
    sched.write_text(sched.read_text() + SEEDS[rule])
    out = io.StringIO()
    code = run_lint([tree], baseline_path=LINT_BASELINE, out=out)
    assert code != 0
    assert rule in out.getvalue()


# ---------------------------------------------------------------------------
# Layer 2: the op audit's committed histograms + the float32 discipline
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def audit_problem():
    from repro_torch.analysis.op_audit import build_tiny_problem
    return build_tiny_problem("cpu")


@pytest.fixture(scope="module")
def audit_report(audit_problem):
    from repro_torch.analysis.op_audit import collect_report
    return collect_report("cpu", prob=audit_problem)


def test_op_audit_matches_committed_baseline(audit_report):
    from repro_torch.analysis.op_audit import (baseline_payload,
                                               compare_baseline)
    base = json.loads(AUDIT_BASELINE.read_text())
    cur = baseline_payload(audit_report)
    snap = base["torch"]
    assert set(snap[sorted(snap)[-1]]) == set(cur)
    out = io.StringIO()
    assert compare_baseline(audit_report, base, out), \
        out.getvalue() + "\nhot-loop op mix drifted; re-baseline with " \
        "`python -m repro_torch.analysis audit --device cpu --update` " \
        "and review the diff"


def test_no_sync_op_on_any_program(audit_report):
    for name, s in audit_report["programs"].items():
        assert s["syncs"] == [], name


def test_float32_discipline_every_program(audit_report):
    """No float64 among any op's operands or outputs in any chunk
    program: distances, norms and merge keys all stay f32."""
    for name, s in audit_report["programs"].items():
        assert s["f64"] == [], f"{name}: {s['f64'][:5]}"


def test_engine_state_dtypes_f32(audit_report):
    """The programs' outputs (engine state leaves + result tensors)
    carry no float64 either: every floating leaf is f32."""
    for name, s in audit_report["programs"].items():
        floats = {d for d in s["out_dtypes"] if d.startswith("torch.float")
                  or d == "torch.bfloat16"}
        assert floats <= {"torch.float32"}, (name, floats)


def test_install_writes_frames_in_place(audit_report):
    inv = audit_report["invariants"]
    assert inv["frames_in_place"] and inv["frame_sized_outputs"] == 0


def test_audit_cli_passes_and_refuses_a_failing_update(
        tmp_path, monkeypatch, audit_problem):
    """`audit` exits 0 on the tree; `--update` writes no baseline from a
    failing audit (a sync op seeded into the install program)."""
    from repro_torch.analysis import op_audit
    from repro_torch.core.pagestore import PageStore
    monkeypatch.setattr(op_audit, "build_tiny_problem",
                        lambda device: audit_problem)
    out = io.StringIO()
    assert op_audit.run_audit(AUDIT_BASELINE, device="cpu", out=out) == 0, \
        out.getvalue()
    install = PageStore._install

    def syncing_install(self, rows, db_d, vn_d):
        install(self, rows, db_d, vn_d)
        float(self.frames.sum())                 # a hidden read
    monkeypatch.setattr(PageStore, "_install", syncing_install)
    target = tmp_path / "audit.json"
    out = io.StringIO()
    assert op_audit.run_audit(target, update=True, device="cpu",
                              out=out) == 1
    assert "refusing" in out.getvalue() and not target.exists()
    assert "pagestore_install: sync ops" in out.getvalue()


# ---------------------------------------------------------------------------
# Layer 3: CaptureGuard
# ---------------------------------------------------------------------------
def test_capture_guard_counts_and_caches():
    def _guard_probe(x):
        return x * 2 + 1

    x = torch.arange(37, dtype=torch.float32)   # unique shape for this test
    with CaptureGuard() as cg:
        CACHE.run("_guard_probe", _guard_probe, (), (x,), 1)
        CACHE.run("_guard_probe", _guard_probe, (), (x + 1,), 1)  # hit
    assert cg.count("_guard_probe") == 1 and cg.total == 1
    assert cg.names == ["_guard_probe"]
    with CaptureGuard() as cg2:
        CACHE.run("_guard_probe", _guard_probe, (), (x,), 1)  # warm
    assert cg2.count("_guard_probe") == 0
    assert CACHE.listeners == []


def test_capture_guard_max_captures_enforced():
    def _guard_limit(x):
        return x + 2

    with pytest.raises(RuntimeError, match="CaptureGuard"):
        with CaptureGuard(match="_guard_limit", max_captures=0):
            CACHE.run("_guard_limit", _guard_limit, (),
                      (torch.arange(11, dtype=torch.float32),), 1)
    assert CACHE.listeners == []
    # the body's own error is not masked by the limit
    with pytest.raises(KeyError):
        with CaptureGuard(max_captures=0):
            CACHE.run("_guard_limit", _guard_limit, (),
                      (torch.arange(13, dtype=torch.float32),), 1)
            raise KeyError("body")
