"""``python -m repro_torch.launch.serve_stream`` against the
reference's on the same flags: the live index (Poisson inserts and deletes, swaps at a full delta
and every 8 mutations, at rest, routed at topr = S, tiered); the JSON equal but the clocks
(``test_torch_serve_stream.check_cli_json``). Split from
tests/test_torch_serve_stream.py so that the suite's workers share its
cases."""
import pytest

from test_torch_serve_stream import _one_torch_thread  # noqa: F401
from test_torch_serve_stream import check_cli_json


@pytest.mark.parametrize("flags", [
    # the live index: Poisson inserts and deletes with swaps at a full
    # delta and every 8 mutations, at rest, routed at topr = S, tiered
    ["--insert-rate", "0.35", "--delete-rate", "0.1", "--delta-cap", "8"],
    ["--insert-rate", "0.5", "--delete-rate", "0.2", "--delta-cap", "16",
     "--refresh-every", "8", "--injit-admit", "off"],
    ["--delta-cap", "8"],
    ["--insert-rate", "0.35", "--delete-rate", "0.1", "--delta-cap", "8",
     "--topr", "4"],
    ["--n", "1024", "--page-size", "8", "--device-pages", "16", "--slots",
     "2", "--round-chunk", "2", "--degree", "8", "--L", "8", "--k", "5",
     "--insert-rate", "0.35", "--delete-rate", "0.1", "--delta-cap", "8"]])
def test_cli_json_matches_reference(tmp_path, capsys, flags):
    check_cli_json(tmp_path, capsys, flags)
