"""``python -m repro_torch.launch.serve_stream`` against the
reference's on the same flags: routing (a spatially partitioned index, legs fused through the
bitonic merge), degraded fusion, the admission ring and the tiered page
store; the JSON equal but the clocks
(``test_torch_serve_stream.check_cli_json``). Split from
tests/test_torch_serve_stream.py so that the suite's workers share its
cases."""
import pytest

from test_torch_serve_stream import _one_torch_thread  # noqa: F401
from test_torch_serve_stream import check_cli_json


@pytest.mark.parametrize("flags", [
    # routing (a spatially partitioned index, legs fused through the
    # bitonic merge), degraded fusion, and the admission ring
    ["--topr", "2"], ["--topr", "2", "--leg-L", "8"],
    ["--topr", "4", "--leg-L", "8", "--injit-admit", "off"],
    ["--topr", "2", "--down-shards", "1"], ["--ring", "8"],
    ["--ring", "4", "--overload", "shed", "--arrival-rate", "0"],
    # the tiered page store: full residency at this size, then half the
    # pages resident on an index of 16 pages per shard
    ["--device-pages", "4"], ["--device-pages", "4", "--no-prefetch"],
    ["--device-pages", "2", "--prefetch-page-w", "0.5"],
    ["--n", "1024", "--page-size", "8", "--device-pages", "16", "--slots",
     "2", "--round-chunk", "2", "--degree", "8", "--L", "8", "--k", "5"]])
def test_cli_json_matches_reference(tmp_path, capsys, flags):
    check_cli_json(tmp_path, capsys, flags)
