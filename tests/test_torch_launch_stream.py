"""``python -m repro_torch.launch.search --stream`` against the
reference's ``--stream --kernel-mode jnp``: the scheduler's options and its fault flags (delay plans, a kill under a
deadline, guarded page corruption); the JSON equal but
the clocks (``test_torch_launch.check_stream_json``). Split from
tests/test_torch_launch.py so that the suite's workers share its
cases."""
import pytest

from test_torch_launch import _one_torch_thread  # noqa: F401 - a fixture
from test_torch_launch import check_stream_json


@pytest.mark.parametrize("flags", [
    ["--arrival-rate", "2", "--slots", "3", "--round-chunk", "4"],
    ["--spec", "2", "--spec-dynamic", "--spec-page-w", "0.5",
     "--arrival-rate", "0.5", "--deadline-rounds", "9",
     "--injit-admit", "off"],
    ["--arrival-rate", "2", "--kill-shard", "1:3", "--delay-shard",
     "0:2:4", "--deadline-rounds", "10"],
    ["--corrupt-pages", "0.1", "--corrupt-mode", "neg", "--nan-guard",
     "--seed", "2"]])
def test_cli_stream_json_matches_reference(tmp_path, capsys, flags):
    check_stream_json(tmp_path, capsys, flags)
