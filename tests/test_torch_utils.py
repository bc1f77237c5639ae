"""Port primitives vs the reference package: the bloom filter bit for bit,
shape math, the device rule, and import hygiene (the port never imports
jax or the reference package)."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.utils as ju
from repro_torch import utils as tu

REPO = Path(__file__).resolve().parents[1]

EDGE_IDS = [-1, 0, 1, 2**31 - 1, 2**31 - 2, 12345, -7]


def _ids(shape, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-2**31, 2**31, size=shape, dtype=np.int64)
    flat = ids.reshape(-1)
    flat[:len(EDGE_IDS)] = EDGE_IDS
    return ids.astype(np.int32)


@pytest.mark.parametrize("num_bits", [64, 2048])
def test_bloom_hashes_match_reference(num_bits):
    ids = _ids((4, 50), seed=num_bits)
    jp1, jp2 = ju.bloom_hashes(jnp.asarray(ids), num_bits)
    tp1, tp2 = tu.bloom_hashes(torch.as_tensor(ids), num_bits)
    np.testing.assert_array_equal(np.asarray(jp1), tp1.numpy())
    np.testing.assert_array_equal(np.asarray(jp2), tp2.numpy())


@pytest.mark.parametrize("words", [2, 64])
def test_bloom_insert_and_query_words_bit_identical(words):
    ids = _ids((3, 40), seed=words)
    rng = np.random.default_rng(words + 1)
    valid = rng.integers(0, 2, size=ids.shape).astype(bool)
    valid[:, :len(EDGE_IDS)] = True
    jb = ju.bloom_insert(jnp.zeros((3, words), jnp.uint32),
                         jnp.asarray(ids), jnp.asarray(valid))
    tb = tu.bloom_insert(torch.zeros((3, words * 32), dtype=torch.bool),
                         torch.as_tensor(ids), torch.as_tensor(valid))
    np.testing.assert_array_equal(np.asarray(jb).astype(np.int64),
                                  tu.bloom_pack(tb).numpy())
    probe = _ids((3, 200), seed=words + 2)
    probe[:, 40:80] = ids          # inserted (where valid) and fresh ids
    np.testing.assert_array_equal(
        np.asarray(ju.bloom_query(jb, jnp.asarray(probe))),
        tu.bloom_query(tb, torch.as_tensor(probe)).numpy())


def test_bloom_insert_twice_is_idempotent_and_ors_collisions():
    ids = torch.tensor([[5, 5, 9, -1]], dtype=torch.int32)
    valid = torch.tensor([[True, True, False, True]])
    b1 = tu.bloom_insert(torch.zeros((1, 64), dtype=torch.bool), ids, valid)
    b2 = tu.bloom_insert(b1, ids, valid)
    assert torch.equal(b1, b2)
    assert tu.bloom_query(b1, ids)[0, [0, 1, 3]].all()


def test_shape_math_matches_reference():
    for a in range(0, 70, 7):
        for b in (1, 3, 8):
            assert tu.cdiv(a, b) == ju.cdiv(a, b)
            assert tu.round_up(a, b) == ju.round_up(a, b)
        assert tu.next_pow2(a) == ju.next_pow2(a)
    assert torch.tensor(tu.BIG_DIST).item() == float(ju.BIG_DIST)  # as f32
    assert tu.INVALID == ju.INVALID_ID


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: 'cuda' resolves")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tu.resolve_device("cuda")
    assert tu.resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_reference():
    """Import every repro_torch module in a fresh interpreter, then check
    sys.modules: no jax*, no repro.*."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith("
        "('jax.', 'jaxlib', 'repro.')) or n == 'repro')\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20          # every module was imported


def test_chip_smoke_imports_neither_jax_nor_the_reference():
    src = (REPO / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from jax" not in src
    assert "from repro." not in src and "import repro." not in src
