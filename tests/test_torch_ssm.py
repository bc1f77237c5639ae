"""The port's Mamba2 SSD block (``models/ssm.py``) against the reference's
on the same numpy weights and inputs at the reduced mamba2 size: the
chunked scan (with and without its carried state) and the recurrent step,
within 2e-4 as tests/test_ssm.py holds its own two paths (f32; the port
batches the intra-chunk products over all chunks, XLA scans them). Plus
the port's twins of tests/test_ssm.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models.params import materialize as j_materialize
from repro.models.ssm import init_ssm_state as j_init_ssm_state
from repro.models.ssm import ssm_chunked as j_ssm_chunked
from repro.models.ssm import ssm_spec as j_ssm_spec
from repro.models.ssm import ssm_step as j_ssm_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import (init_ssm_state, ssm_chunked, ssm_spec,
                                ssm_step)
from repro_torch.models.params import materialize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def carried():
    jcfg = j_reduced(j_get_config("mamba2-780m"))
    cfg = reduced(get_config("mamba2-780m"))
    jp = dict(j_materialize(j_ssm_spec(jcfg), jax.random.PRNGKey(0)))
    # A_log, dt_bias and D start at 0, 0 and 1: give them values, so the
    # decay, the step size and the skip all bite
    rng = np.random.default_rng(7)
    for name in ("A_log", "dt_bias", "D"):
        jp[name] = jnp.asarray(
            0.5 * rng.standard_normal(jp[name].shape).astype(np.float32))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _x(seed, B, S, d, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(
        (B, S, d))).astype(np.float32)


@pytest.mark.parametrize("S,chunk", [(24, 8), (40, 16), (13, 128)])
def test_ssm_chunked_matches_reference(carried, S, chunk):
    jcfg, cfg, jp, tp = carried
    x = _x(1, 2, S, cfg.d_model)
    want = j_ssm_chunked(jp, jnp.asarray(x), jcfg, chunk=chunk)
    got = ssm_chunked(tp, torch.from_numpy(x), cfg, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, (wst, wconv) = j_ssm_chunked(jp, jnp.asarray(x), jcfg, chunk=chunk,
                                       return_state=True)
    got, (st, conv) = ssm_chunked(tp, torch.from_numpy(x), cfg, chunk=chunk,
                                  return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(wst), **TOL)
    np.testing.assert_allclose(conv.numpy(), np.asarray(wconv), **TOL)
    assert conv.shape == (2, cfg.ssm_conv - 1,
                          cfg.d_inner + 2 * cfg.ssm_state)


def test_ssm_step_matches_reference(carried):
    jcfg, cfg, jp, tp = carried
    x = _x(2, 2, 6, cfg.d_model)
    jstate = j_init_ssm_state(jcfg, 2)
    state = init_ssm_state(cfg, 2, device="cpu")
    for t in range(x.shape[1]):
        want, jstate = j_ssm_step(jp, jnp.asarray(x[:, t:t + 1]), jstate,
                                  jcfg)
        got, state = ssm_step(tp, torch.from_numpy(x[:, t:t + 1]), state,
                              cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=f"step {t}")
        for g, w in zip(state, jstate):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


# the port's twins of tests/test_ssm.py
@pytest.fixture(scope="module")
def setup():
    cfg = reduced(get_config("mamba2-780m"))
    return cfg, materialize(ssm_spec(cfg), torch.Generator().manual_seed(0))


def _randn(seed, shape, scale):
    return scale * torch.randn(shape,
                               generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_chunked_matches_recurrent(setup, chunk):
    cfg, params = setup
    B, S = 2, 24
    x = _randn(1, (B, S, cfg.d_model), 0.5)
    y_chunked = ssm_chunked(params, x, cfg, chunk=chunk)
    state = init_ssm_state(cfg, B, device="cpu")
    ys = []
    for t in range(S):
        y_t, state = ssm_step(params, x[:, t:t + 1], state, cfg)
        ys.append(y_t)
    torch.testing.assert_close(y_chunked, torch.cat(ys, dim=1), **TOL)


def test_chunk_size_invariance(setup):
    cfg, params = setup
    x = _randn(2, (1, 32, cfg.d_model), 0.5)
    torch.testing.assert_close(ssm_chunked(params, x, cfg, chunk=8),
                               ssm_chunked(params, x, cfg, chunk=32), **TOL)


def test_prefill_state_handoff(setup):
    """chunked(return_state) -> ssm_step continues the exact sequence."""
    cfg, params = setup
    B, S = 1, 16
    x = _randn(3, (B, S + 4, cfg.d_model), 0.5)
    y_full = ssm_chunked(params, x, cfg, chunk=8)
    y_pre, state = ssm_chunked(params, x[:, :S], cfg, chunk=8,
                               return_state=True)
    torch.testing.assert_close(y_pre, y_full[:, :S], **TOL)
    for t in range(4):
        y_t, state = ssm_step(params, x[:, S + t:S + t + 1], state, cfg)
        torch.testing.assert_close(y_t[:, 0], y_full[:, S + t], rtol=3e-4,
                                   atol=3e-4)


def test_no_nan_long(setup):
    cfg, params = setup
    x = _randn(4, (1, 128, cfg.d_model), 2.0)
    assert torch.isfinite(ssm_chunked(params, x, cfg, chunk=16)).all()
