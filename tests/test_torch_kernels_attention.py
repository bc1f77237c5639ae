"""Flash attention: the port's plain version and op vs the reference's
Pallas kernel (interpret mode) and its jnp oracle, on the same numpy
inputs — the sweep of tests/test_kernels_attention.py plus gemma3-1b's
head geometry. Tolerances are the reference tests': 2e-5 in f32 (the
online softmax sums in another order than the one-shot softmax), 3e-2
in bf16 (the output is rounded to bf16)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import attention_op as j_op
from repro.kernels.flash_attention import attention_ref as j_ref
from repro.kernels.flash_attention import flash_attention as j_fa
from repro_torch.kernels.flash_attention import (attention_op, attention_ref,
                                                 flash_attention)


def _mk(B, H, Hkv, S, dh, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((B, H, S, dh)) * 0.5).astype(dtype)
    k = (rng.standard_normal((B, Hkv, S, dh)) * 0.5).astype(dtype)
    v = (rng.standard_normal((B, Hkv, S, dh)) * 0.5).astype(dtype)
    return q, k, v


def _t(x):
    t = torch.from_numpy(np.asarray(x, np.float32))
    return t.bfloat16() if x.dtype == jnp.bfloat16 else t


def _close(got, *wants, tol):
    g = got.float().numpy()
    for w in wants:
        np.testing.assert_allclose(g, np.asarray(w, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,Hkv,S,dh,bq,bk", [
    (1, 2, 2, 128, 64, 64, 64),
    (2, 4, 1, 256, 64, 128, 128),   # GQA group=4
    (1, 8, 2, 128, 128, 64, 32),    # GQA group=4, uneven blocks
    (1, 4, 1, 128, 256, 64, 64),    # gemma3-1b heads: H=4, Hkv=1, dh=256
])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_causal_matches_pallas_and_oracle(B, H, Hkv, S, dh, bq, bk, dtype):
    q, k, v = _mk(B, H, Hkv, S, dh, dtype)
    scale = 1.0 / np.sqrt(dh)
    pallas = j_fa(q, k, v, scale=scale, causal=True, block_q=bq,
                  block_k=bk, interpret=True)
    oracle = j_ref(q, k, v, scale=scale, causal=True)
    got = attention_ref(_t(q), _t(k), _t(v), scale=scale, causal=True)
    assert got.dtype == _t(q).dtype
    _close(got, pallas, oracle, tol=2e-5 if dtype == np.float32 else 3e-2)
    op = attention_op(_t(q), _t(k), _t(v), scale=scale, causal=True,
                      mode="ref")
    torch.testing.assert_close(op, got, rtol=0, atol=0)


@pytest.mark.parametrize("window", [32, 64])
@pytest.mark.parametrize("dh,H,Hkv", [(64, 2, 2), (256, 4, 1)])
def test_sliding_window(window, dh, H, Hkv):
    q, k, v = _mk(1, H, Hkv, 256, dh, np.float32)
    scale = dh ** -0.5
    pallas = j_fa(q, k, v, scale=scale, causal=True, window=window,
                  block_q=64, block_k=64, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), scale=scale, causal=True,
                          window=window)
    _close(got, pallas, j_ref(q, k, v, scale=scale, causal=True,
                              window=window), tol=2e-5)


def test_softcap():
    q, k, v = _mk(1, 2, 1, 128, 64, np.float32, seed=7)
    pallas = j_fa(q, k, v, scale=0.125, causal=True, softcap=30.0,
                  block_q=64, block_k=64, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.125, causal=True,
                          softcap=30.0)
    _close(got, pallas, tol=2e-5)


def test_noncausal():
    q, k, v = _mk(1, 2, 2, 128, 64, np.float32, seed=5)
    pallas = j_fa(q, k, v, scale=0.125, causal=False, block_q=64,
                  block_k=64, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.125, causal=False)
    _close(got, pallas, tol=2e-5)


@pytest.mark.parametrize("S,window", [(100, 0), (125, 16)])
def test_op_pads_nonaligned(S, window):
    q, k, v = _mk(1, 2, 2, S, 64, np.float32, seed=9)
    pallas = j_op(q, k, v, scale=0.125, causal=True, window=window,
                  mode="interpret", block_q=64, block_k=64)
    got = attention_op(_t(q), _t(k), _t(v), scale=0.125, causal=True,
                       window=window, mode="auto")
    assert got.shape == (1, 2, S, 64)
    _close(got, pallas, j_ref(q, k, v, scale=0.125, causal=True,
                              window=window), tol=2e-5)


def test_kv_padding_s_orig():
    """Padded kv rows beyond s_orig are masked, as the Pallas kernel
    masks them."""
    q, k, v = _mk(1, 4, 2, 128, 64, np.float32, seed=3)
    k[:, :, 100:] = 7.0                     # padding junk that must not count
    v[:, :, 100:] = -7.0
    pallas = j_fa(q, k, v, scale=0.125, causal=False, s_orig=100,
                  block_q=64, block_k=64, interpret=True)
    got = flash_attention(_t(q), _t(k), _t(v), scale=0.125, causal=False,
                          s_orig=100)
    _close(got, pallas, j_ref(q, k[:, :, :100], v[:, :, :100],
                              scale=0.125, causal=False), tol=2e-5)


@pytest.mark.parametrize("kv_valid,Skv", [(100, 128), (57, 96),
                                           (128, 128), (500, 128)])
def test_op_kv_valid_is_the_cross_attention_bound(kv_valid, Skv):
    """attention_op's valid-length bound (cross-attention over a padded
    encoder cache): rows from min(kv_valid, Skv) on do not count, as the
    Pallas kernel's s_orig and the reference's cross-attention mask
    (``attn_direct(..., kv_valid=enc_valid)``) leave them out."""
    from repro.models.attention import attn_direct as j_attn_direct
    rng = np.random.default_rng(kv_valid)
    q = (rng.standard_normal((2, 4, 96, 64)) * 0.5).astype(np.float32)
    k, v = ((rng.standard_normal((2, 2, Skv, 64)) * 0.5).astype(np.float32)
            for _ in range(2))
    valid = min(kv_valid, Skv)
    k[:, :, valid:] = 7.0                   # padding junk that must not count
    v[:, :, valid:] = -7.0
    pallas = j_fa(q, k, v, scale=0.125, causal=False, s_orig=valid,
                  block_q=32, block_k=32, interpret=True)
    direct = j_attn_direct(jnp.swapaxes(q, 1, 2), jnp.swapaxes(k, 1, 2),
                           jnp.swapaxes(v, 1, 2), scale=0.125, causal=False,
                           kv_valid=kv_valid)
    got = attention_op(_t(q), _t(k), _t(v), scale=0.125, causal=False,
                       kv_valid=kv_valid)
    _close(got, pallas, jnp.swapaxes(direct, 1, 2), tol=2e-5)
    with pytest.raises(ValueError, match="kv_valid"):
        attention_op(_t(q), _t(k), _t(v), scale=0.125, kv_valid=0)


def test_modes_and_shape_checks_on_cpu():
    q, k, v = (_t(x) for x in _mk(1, 2, 2, 64, 16, np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        attention_op(q, k, v, scale=0.25, mode="cuda")
    with pytest.raises(ValueError):
        attention_op(q, k, v, scale=0.25, mode="pallas")
    with pytest.raises(ValueError, match="multiples"):
        flash_attention(q[:, :, :40], k, v, scale=0.25)
    with pytest.raises(ValueError, match="multiple of"):
        flash_attention(q, k[:, :1].expand(1, 3, 64, 16), v, scale=0.25)
