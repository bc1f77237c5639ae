"""The port's worked examples (``examples/torch/``), each run as a
subprocess on the CPU (``--device cpu``) at the smallest flags its
reference in ``examples/`` accepts, all at once: exit 0 and finite
printed figures. The quickstart twin and the reference's
``examples/quickstart.py`` run at their default size side by side and
their recall@10 agree within 0.01 (the repo's standard on real-valued
data). No file under ``examples/torch/`` imports the reference.
"""
import ast
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TWINS = REPO / "examples" / "torch"
RECALL_ATOL = 0.01
TIMEOUT_S = 300
RUNS = {
    "quickstart": [str(TWINS / "quickstart.py"), "--device", "cpu"],
    "quickstart_reference": [str(REPO / "examples" / "quickstart.py")],
    "two_stage": [str(TWINS / "two_stage.py"), "--device", "cpu"],
    "serve_batched": [str(TWINS / "serve_batched.py"), "--device", "cpu",
                      "--batch", "2", "--gen", "4"],
    "train_lm": [str(TWINS / "train_lm.py"), "--device", "cpu", "--steps",
                 "3", "--batch", "2", "--seq", "32"],
}


def number(pattern: str, text: str) -> float:
    m = re.search(pattern, text)
    assert m, (pattern, text[-2000:])
    return float(m.group(1))


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    procs = {name: subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, argv in RUNS.items()}
    out = {}
    try:
        for name, p in procs.items():
            out[name] = (p.communicate(timeout=TIMEOUT_S)[0], p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def test_quickstart_recall_equals_the_references(runs):
    """The twin's recall@10 within 0.01 of the reference example's; its
    rounds and page reads printed for the record."""
    (mine, rc), (ref, ref_rc) = runs["quickstart"], \
        runs["quickstart_reference"]
    assert rc == 0 and ref_rc == 0, (mine[-2000:], ref[-2000:])
    got = number(r"recall@10\s*=\s*([\d.]+)", mine)
    want = number(r"recall@10\s*=\s*([\d.]+)", ref)
    assert abs(got - want) <= RECALL_ATOL, (got, want)
    for what in (r"rounds\s*=\s*(\d+)", r"page reads\s*=\s*(\d+)"):
        print(what, number(what, mine), number(what, ref))
    assert "OK" in mine.splitlines()


def test_two_stage_retrieves_and_ranks(runs):
    out, rc = runs["two_stage"]
    assert rc == 0, out[-2000:]
    for what in (r"retrieve: ([\d.]+)s", r"rank: ([\d.]+)s",
                 r"share of end-to-end: (\d+)%"):
        assert math.isfinite(number(what, out))
    assert len(re.findall(r"query 0 \w+ *: \[(\d+(?:, \d+){7})\]", out)) == 2


def test_serve_batched_generates(runs):
    import json
    out, rc = runs["serve_batched"]
    assert rc == 0, out[-2000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["gen"] == 4
    assert all(math.isfinite(line[k]) for k in ("tok_s", "prefill_ms",
                                                "decode_ms_per_token"))


def test_train_lm_trains(runs):
    out, rc = runs["train_lm"]
    assert rc == 0, out[-2000:]
    losses = [float(x) for x in re.findall(r"loss ([-\d.naif]+)", out)]
    assert losses and all(math.isfinite(x) for x in losses)
    assert "done at step 3" in out


def test_twins_import_nothing_of_the_reference():
    names = sorted(TWINS.glob("*.py"))
    assert [p.name for p in names] == sorted(
        p.name for p in (REPO / "examples").glob("*.py"))
    for path in names:
        for node in ast.walk(ast.parse(path.read_text())):
            mods = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) \
                else []
            for mod in mods:
                assert mod.split(".")[0] not in ("repro", "jax"), \
                    (path.name, mod)


def test_twins_refuse_the_cpu_unless_asked():
    """Without ``--device cpu`` a twin runs on the card, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs on it")
    p = subprocess.run(
        [sys.executable, str(TWINS / "serve_batched.py"), "--gen", "1"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO / "src")),
        capture_output=True, text=True, timeout=TIMEOUT_S)
    assert p.returncode != 0
    assert "torch.cuda.is_available() is False" in p.stderr
