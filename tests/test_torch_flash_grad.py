"""The port's attention gradients on the CPU.

(1) The twins of tests/test_flash_attention.py over its CASES: the
port's chunked ``flash_attention`` (its recomputing backward
``_fa_bwd_impl``) against ``attn_direct``, forward and gradients, and
``attn_chunked``. (2) The training path's ``FlashAttentionFn`` (through
``attention_op``; on CPU tensors its plain versions ``attention_fwd_ref``
and ``attention_bwd_ref``) against the reference's ``jax.grad`` of
``attn_direct`` and of its ``flash_attention`` on the same numpy inputs.
(3) ``attention_bwd_ref`` against torch autograd of ``attention_ref``.

Tolerances: forward 2e-5 and gradients 5e-4 (rtol and atol), the
reference test's; bf16 2e-2, the reference test's; the plain backward
against autograd 1e-5 (both f32, the same products in other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import attn_direct as j_direct
from repro.models.attention import flash_attention as j_flash
from repro_torch.kernels.flash_attention import attention_op, attention_ref
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_fwd_ref)
from repro_torch.models.attention import (attn_chunked, attn_direct,
                                          flash_attention)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CASES = [
    # B, Sq, Sk, H, K, hd, causal, window, softcap, kv_valid
    (2, 256, 256, 4, 2, 16, True, 0, 0.0, None),
    (1, 128, 384, 4, 4, 8, True, 64, 0.0, None),
    (2, 192, 192, 8, 2, 16, True, 0, 30.0, None),
    (1, 256, 256, 4, 1, 16, False, 0, 0.0, 200),
    (1, 96, 320, 2, 1, 32, True, 48, 20.0, 280),
]
FWD_TOL = 2e-5
GRAD_TOL = 5e-4


def _mk(case, seed):
    """numpy q (B,Sq,H,hd), k, v (B,Sk,K,hd), dy, and the kwargs."""
    B, Sq, Sk, H, K, hd = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, K, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, K, hd), dtype=np.float32)
    kw = dict(scale=hd ** -0.5, causal=case[6], window=case[7],
              softcap=case[8], kv_valid=case[9])
    return q, k, v, kw


def _t(*xs, grad=False):
    return [torch.tensor(x, requires_grad=grad) for x in xs]


def _direct(q, k, v, kw):
    kv = k.shape[1] if kw["kv_valid"] is None else kw["kv_valid"]
    return attn_direct(q, k, v, **dict(kw, kv_valid=kv))


def _grads(fn, q, k, v):
    """Gradients of sum(fn(q, k, v) ** 2) w.r.t. q, k, v (numpy in)."""
    tq, tk, tv = _t(q, k, v, grad=True)
    (fn(tq, tk, tv) ** 2).sum().backward()
    return [x.grad.numpy() for x in (tq, tk, tv)]


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("case", CASES)
def test_forward_matches_direct(case):
    q, k, v, kw = _mk(case, 0)
    tq, tk, tv = _t(q, k, v)
    y = flash_attention(tq, tk, tv, q_chunk=64, kv_chunk=128, **kw)
    _close(y, _direct(tq, tk, tv, kw), FWD_TOL)


@pytest.mark.parametrize("case", CASES)
def test_grads_match_direct(case):
    q, k, v, kw = _mk(case, 1)
    g_ref = _grads(lambda *a: _direct(*a, kw), q, k, v)
    g_fa = _grads(lambda *a: flash_attention(*a, q_chunk=64, kv_chunk=128,
                                             **kw), q, k, v)
    for a, b in zip(g_fa, g_ref):
        _close(a, b, GRAD_TOL)


def test_matches_attn_chunked_forward():
    q, k, v, kw = _mk(CASES[0], 2)
    tq, tk, tv = _t(q, k, v)
    y1 = attn_chunked(tq, tk, tv, q_chunk=64, kv_chunk=128, **kw)
    y2 = flash_attention(tq, tk, tv, q_chunk=64, kv_chunk=128, **kw)
    _close(y1, y2, 1e-6)


def test_bf16_inputs():
    q, k, v, kw = _mk(CASES[0], 3)
    tq, tk, tv = (x.bfloat16() for x in _t(q, k, v))
    y = flash_attention(tq, tk, tv, q_chunk=64, kv_chunk=128, **kw)
    assert y.dtype == torch.bfloat16
    _close(y.float(), _direct(tq, tk, tv, kw).float(), 2e-2)


def test_ragged_lengths_pad():
    """Sq/Sk not multiples of the chunk sizes."""
    q, k, v, kw = _mk((1, 130, 201, 2, 1, 8, False, 0, 0.0, 201), 4)
    tq, tk, tv = _t(q, k, v)
    y = flash_attention(tq, tk, tv, q_chunk=64, kv_chunk=64, **kw)
    _close(y, _direct(tq, tk, tv, kw), FWD_TOL)


def _op(q, k, v, kw):
    """attention_op in the model layout (B,S,H,hd)."""
    out = attention_op(q.transpose(1, 2), k.transpose(1, 2),
                       v.transpose(1, 2), scale=kw["scale"],
                       causal=kw["causal"], window=kw["window"],
                       softcap=kw["softcap"], kv_valid=kw["kv_valid"])
    return out.transpose(1, 2)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("ref", ["direct", "flash"])
def test_flash_fn_matches_reference_grad(case, ref):
    """FlashAttentionFn on CPU tensors through attention_op (padded to
    the kernel's 32-row blocks, its own plain fwd/bwd) against jax.grad
    of the reference's attn_direct and of its custom-VJP flash."""
    q, k, v, kw = _mk(case, 5)
    jfn = {"direct": lambda *a: j_direct(*a, **kw),
           "flash": lambda *a: j_flash(*a, q_chunk=64, kv_chunk=128,
                                       **kw)}[ref]

    def jloss(q, k, v):
        return (jfn(q, k, v) ** 2).sum()

    jq = [jnp.asarray(x) for x in (q, k, v)]
    jy = jax.jit(jfn)(*jq)
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*jq)
    tq, tk, tv = _t(q, k, v, grad=True)
    y = _op(tq, tk, tv, kw)
    _close(y.detach(), jy, FWD_TOL)
    (y ** 2).sum().backward()
    for a, b in zip((tq, tk, tv), jg):
        _close(a.grad, b, GRAD_TOL)


def test_attention_op_uses_flash_fn_only_under_grad():
    """No grad: the plain forward, no lse; grad on: the autograd
    function (its backward node); mode 'ref': attention_ref as it is."""
    q, k, v, kw = _mk(CASES[0], 6)
    tq, tk, tv = (x.transpose(1, 2) for x in _t(q, k, v, grad=True))
    args = dict(scale=kw["scale"], causal=True)
    with torch.no_grad():
        assert attention_op(tq, tk, tv, **args).grad_fn is None
    y = attention_op(tq, tk, tv, **args)
    assert "FlashAttentionFn" in type(y.grad_fn.next_functions[0][0]).__name__
    y_ref = attention_op(tq, tk, tv, mode="ref", **args)
    assert "FlashAttentionFn" not in str(y_ref.grad_fn)
    _close(y.detach(), y_ref.detach(), FWD_TOL)
    with pytest.raises(ValueError, match="cuda"):
        attention_op(tq, tk, tv, mode="cuda", **args)


BWD_CASES = [
    # B, H, Hkv, S, Skv, dh, causal, window, softcap, s_orig
    (2, 4, 1, 64, 64, 16, True, 0, 0.0, 0),
    (1, 4, 2, 96, 96, 32, True, 40, 0.0, 0),
    (1, 4, 4, 64, 64, 16, True, 0, 50.0, 0),
    (1, 2, 1, 64, 96, 16, False, 0, 0.0, 70),
    (1, 8, 2, 96, 96, 8, True, 7, 20.0, 0),
]


@pytest.mark.parametrize("case", BWD_CASES)
def test_attention_bwd_ref_matches_autograd(case):
    """The plain backward (from the plain forward's lse) against torch
    autograd of attention_ref: softcap, window, GQA, non-causal and a
    valid-length bound."""
    B, H, Hkv, S, Skv, dh, causal, window, softcap, s_orig = case
    rng = np.random.default_rng(7)
    q, k, v = (torch.tensor(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, H, S, dh), (B, Hkv, Skv, dh), (B, Hkv, Skv, dh)))
    dout = torch.tensor(rng.standard_normal((B, H, S, dh), dtype=np.float32))
    kw = dict(scale=dh ** -0.5, causal=causal, window=window,
              softcap=softcap, s_orig=s_orig)
    out, lse = attention_fwd_ref(q, k, v, **kw)
    got = attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    attention_ref(*leaves, **kw).backward(dout)
    for a, b in zip(got, leaves):
        _close(a, b.grad, 1e-5)
    # lse is the log-sum-exp of the masked scores
    assert torch.isfinite(lse).all() and lse.shape == (B, H, S)
