"""One train step of a reduced arch of every other model family on the
CPU against the reference's (tests/test_torch_train.py holds the dense
archs over three steps): the port's forward of each family is
differentiable and gives the reference's loss and global grad norm
within 1e-4 relative (f32 on both sides, sums in other orders)."""
import pytest

from test_torch_train import _check_rows, _one_torch_thread, _parity  # noqa: F401


@pytest.mark.parametrize("arch", ["llava-next-mistral-7b", "mixtral-8x7b",
                                  "mamba2-780m", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_family_step_matches_reference(arch):
    """One step of a reduced arch of every other family (vlm with the
    vision stand-in, moe with its load-balance loss, ssm, hybrid, encdec
    with audio frames): the loss and grad norm of the reference's."""
    rows, _, _ = _parity(arch, 1)
    _check_rows(rows)
