"""``python -m repro_torch.launch.search --stream`` against the
reference's ``--stream --kernel-mode jnp``: routed serving on the spatially
partitioned index and the tiered page store; the JSON equal but
the clocks (``test_torch_launch.check_stream_json``). Split from
tests/test_torch_launch.py so that the suite's workers share its
cases."""
import pytest

from test_torch_launch import _one_torch_thread  # noqa: F401 - a fixture
from test_torch_launch import check_stream_json


@pytest.mark.parametrize("flags", [
    # routed serving on the spatially partitioned index
    ["--topr", "2", "--arrival-rate", "2"],
    ["--topr", "2", "--leg-L", "8", "--down-shards", "1"],
    # the tiered page store: full residency at this size, then half the
    # pages resident on an index of 16 pages per shard
    ["--device-pages", "4"], ["--device-pages", "4", "--no-prefetch"],
    ["--device-pages", "2", "--prefetch-page-w", "0.5"],
    ["--n", "1024", "--page-size", "8", "--device-pages", "16", "--slots",
     "2", "--round-chunk", "2", "--degree", "8", "--L", "8", "--k", "5"]])
def test_cli_stream_json_matches_reference(tmp_path, capsys, flags):
    check_stream_json(tmp_path, capsys, flags)
