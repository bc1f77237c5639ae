"""The port's MoE layer (``models/moe.py``) against the reference's on the
same numpy weights and inputs, at the reduced mixtral (4 experts top-2)
and dbrx (4 experts top-2) sizes: outputs within 1e-5 relative to the
largest |output| (f32; torch and XLA sum the expert products in other
orders, and the reference's init — expert weights at 1/sqrt(E) — makes
outputs O(100)), the same experts picked, the same items dropped,
drop_frac and lb_loss equal. Plus the port's twins of
tests/test_moe.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.core.dispatch import compute_ranks as j_compute_ranks
from repro.models.moe import moe_ffn as j_moe_ffn
from repro.models.moe import moe_spec as j_moe_spec
from repro.models.params import materialize as j_materialize
from repro_torch.configs import get_config, reduced
from repro_torch.models import moe_ffn
from repro_torch.models.moe import capacity, moe_spec, route
from repro_torch.models.params import materialize


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-5
CFG = reduced(get_config("mixtral-8x7b"))


def _carried(arch, key):
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jp = j_materialize(j_moe_spec(jcfg), jax.random.PRNGKey(key))
    tp = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp


def _reference_routing(jp, x, jcfg, cap_factor):
    """The reference moe_ffn's routing, step for step (its own functions)."""
    T = x.shape[0] * x.shape[1]
    xt = jnp.asarray(x).reshape(T, -1)
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["wg"], axis=-1)
    _, top_e = jax.lax.top_k(probs, jcfg.num_experts_per_tok)
    dest = top_e.reshape(-1).astype(jnp.int32)
    rank, _ = j_compute_ranks(dest, jnp.ones(dest.shape, bool),
                              jcfg.num_experts)
    cap = int(-(-max(int(T * jcfg.num_experts_per_tok / jcfg.num_experts
                         * cap_factor), 4) // 4) * 4)
    return np.asarray(top_e), np.asarray(rank), cap


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "dbrx-132b"])
@pytest.mark.parametrize("cap_factor", [0.5, 1.25, 4.0])
def test_moe_ffn_matches_reference(arch, cap_factor):
    jcfg, cfg, jp, tp = _carried(arch, 0)
    x = np.random.default_rng(1).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    want, jaux = j_moe_ffn(jp, jnp.asarray(x), jcfg,
                           capacity_factor=cap_factor, act=jcfg.act)
    got, aux = moe_ffn(tp, torch.from_numpy(x), cfg,
                       capacity_factor=cap_factor, act=cfg.act)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # the same routing and the same dropped items
    top_e, rank, cap = _reference_routing(jp, x, jcfg, cap_factor)
    _, t_top_e, t_rank, ok, t_cap, _ = route(
        tp, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg, cap_factor)
    assert t_cap == cap == capacity(48, cfg, cap_factor)
    np.testing.assert_array_equal(t_top_e.numpy(), top_e)
    np.testing.assert_array_equal(t_rank.numpy(), rank)
    np.testing.assert_array_equal(ok.numpy(), rank < cap)
    assert (cap_factor == 0.5) == bool((~ok).any())
    assert float(aux["drop_frac"]) == pytest.approx(
        float(jaux["drop_frac"]), abs=1e-7)
    assert float(aux["drop_frac"]) == pytest.approx(
        float((~ok).sum()) / ok.numel(), abs=1e-7)
    assert float(aux["lb_loss"]) == pytest.approx(float(jaux["lb_loss"]),
                                                  rel=1e-6)


def _dense_oracle(p, x, cfg):
    """Mixture computed without any dispatch: every token through every
    expert, weighted by the renormalised top-k gate probabilities."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    probs = torch.softmax(xt @ p["wg"], dim=-1)
    top_p, top_e = torch.topk(probs, cfg.num_experts_per_tok, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    h1 = torch.einsum("td,edf->tef", xt, p["w1"])
    h3 = torch.einsum("td,edf->tef", xt, p["w3"])
    out_all = torch.einsum("tef,efd->ted", F.silu(h1) * h3, p["w2"])
    gathered = torch.gather(out_all, 1, top_e[:, :, None].expand(-1, -1, d))
    return (gathered * top_p[:, :, None]).sum(1).reshape(B, S, d)


def _params(seed):
    return materialize(moe_spec(CFG), torch.Generator().manual_seed(seed))


def _x(seed, S):
    return torch.randn((2, S, CFG.d_model),
                       generator=torch.Generator().manual_seed(seed))


def test_lossless_matches_dense_oracle():
    p = _params(0)
    x = _x(1, 16)
    got, aux = moe_ffn(p, x, CFG, capacity_factor=float(CFG.num_experts))
    assert float(aux["drop_frac"]) == 0.0
    torch.testing.assert_close(got, _dense_oracle(p, x, CFG), rtol=2e-4,
                               atol=2e-4)


def test_capacity_drops_counted():
    p = _params(2)
    x = _x(3, 64)
    _, aux_tight = moe_ffn(p, x, CFG, capacity_factor=0.25)
    _, aux_loose = moe_ffn(p, x, CFG, capacity_factor=float(CFG.num_experts))
    assert float(aux_tight["drop_frac"]) > 0.0
    assert float(aux_loose["drop_frac"]) == 0.0


def test_lb_loss_favors_balance():
    """Uniform routing probabilities minimise the switch LB loss (== 1)."""
    p = {k: v.clone() for k, v in _params(4).items()}
    p["wg"] = torch.zeros_like(p["wg"])               # uniform gate
    x = _x(5, 32)
    _, aux = moe_ffn(p, x, CFG, capacity_factor=float(CFG.num_experts))
    assert 0.9 <= float(aux["lb_loss"]) <= 1.6        # near-ideal balance

    p["wg"][:, 0] = 100.0                             # collapse to expert 0
    x_pos = x.abs() + 0.1                             # sum(x) > 0: expert 0
    _, aux2 = moe_ffn(p, x_pos, CFG, capacity_factor=float(CFG.num_experts))
    assert float(aux2["lb_loss"]) > float(aux["lb_loss"]) + 0.5
