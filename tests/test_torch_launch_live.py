"""``python -m repro_torch.launch.search --stream`` against the
reference's ``--stream --kernel-mode jnp``: the live index (swaps at a full
delta, and every 6 mutations routed at topr = S); the JSON equal but
the clocks (``test_torch_launch.check_stream_json``). Split from
tests/test_torch_launch.py so that the suite's workers share its
cases."""
import pytest

from test_torch_launch import _one_torch_thread  # noqa: F401 - a fixture
from test_torch_launch import check_stream_json


@pytest.mark.parametrize("flags", [
    # the live index: swaps at a full delta, and every 6 mutations
    # routed at topr = S
    ["--arrival-rate", "2", "--insert-rate", "0.35", "--delete-rate",
     "0.1", "--delta-cap", "8"],
    ["--arrival-rate", "1", "--insert-rate", "0.4", "--delete-rate",
     "0.2", "--delta-cap", "8", "--refresh-every", "6", "--topr", "8"]])
def test_cli_stream_json_matches_reference(tmp_path, capsys, flags):
    check_stream_json(tmp_path, capsys, flags)
