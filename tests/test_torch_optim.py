"""The port's optimizer against the reference's: AdamW step for step
(full and factored v), the schedule, the int8 quantizer's bound
(hypothesis, as tests/test_optim.py), error feedback, and the cross-pod
sync at world 2 over gloo.

Tolerances: parameters against the reference's ``apply_updates`` 1e-6
(atol and rtol, the same f32 operations in the same order); the
schedule 1e-6; the rest as in tests/test_optim.py.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro import checkpoint as j_ckpt
from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.data import TokenPipeline as JTokenPipeline
from repro.models import ModelOpts as JModelOpts
from repro.models import init_params as j_init_params
from repro.optim.adamw import OptConfig as JOC
from repro.optim.adamw import apply_updates as j_apply
from repro.optim.adamw import init_opt as j_init
from repro.optim.schedule import warmup_cosine as j_warmup_cosine
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config, reduced
from repro_torch.models.transformer import ModelOpts
from repro_torch.optim.adamw import OptConfig, apply_updates, init_opt
from repro_torch.optim.compress import (EFState, dequantize_int8,
                                        ef_compress, ef_init, quantize_int8)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.trainer import load_state, state_like, state_tree


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


REPO = Path(__file__).resolve().parents[1]


def _ref_adamw(p, g, m, v, t, oc, lr):
    m = oc.b1 * m + (1 - oc.b1) * g
    v = oc.b2 * v + (1 - oc.b2) * g * g
    mh = m / (1 - oc.b1 ** t)
    vh = v / (1 - oc.b2 ** t)
    p = p - lr * (mh / (np.sqrt(vh) + oc.eps) + oc.weight_decay * p)
    return p, m, v


def test_adamw_matches_straightforward_reference():
    oc = OptConfig(lr_max=1e-2, schedule="constant", weight_decay=0.01)
    rng = np.random.default_rng(0)
    p = {"w": torch.tensor(rng.standard_normal((5, 3), dtype=np.float32))}
    st_ = init_opt(p, oc)
    pr = p["w"].numpy().astype(np.float64)
    mr, vr = np.zeros_like(pr), np.zeros_like(pr)
    for t in range(1, 6):
        g = rng.standard_normal((5, 3), dtype=np.float32)
        p, st_ = apply_updates(p, {"w": torch.tensor(g)}, st_, oc)
        pr, mr, vr = _ref_adamw(pr, g.astype(np.float64), mr, vr, t, oc,
                                1e-2)
    assert int(st_["step"]) == 5 and st_["step"].dtype == torch.int32
    np.testing.assert_allclose(p["w"].numpy(), pr, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_matches_reference_apply_updates(factored):
    """Five steps of the warmup-cosine schedule on a tree with a matrix,
    a 3-d tensor and a vector (factored v: r/c and f leaves)."""
    kw = dict(lr_max=1e-2, warmup=2, decay_steps=6, weight_decay=0.1,
              factored_v=factored)
    oc, joc = OptConfig(**kw), JOC(**kw)
    rng = np.random.default_rng(1)
    shapes = {"a": (6, 4), "b": {"c": (3, 5, 2), "d": (7,)}}

    def draw(sh):
        if isinstance(sh, dict):
            return {k: draw(v) for k, v in sh.items()}
        return rng.standard_normal(sh, dtype=np.float32)

    p0 = draw(shapes)
    tmap = jax.tree_util.tree_map
    p = tmap(torch.tensor, p0)
    jp = tmap(jnp.asarray, p0)
    st_, jst = init_opt(p, oc), j_init(jp, joc)
    for _ in range(5):
        g = draw(shapes)
        p, st_ = apply_updates(p, tmap(torch.tensor, g), st_, oc)
        jp, jst = j_apply(jp, tmap(jnp.asarray, g), jst, joc)
    for a, b in zip(jax.tree_util.tree_leaves(tmap(lambda x: x.numpy(), p)),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    for a, b in zip(
            jax.tree_util.tree_leaves(tmap(lambda x: x.numpy(), st_["v"])),
            jax.tree_util.tree_leaves(jst["v"])):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-12)
    assert int(st_["step"]) == int(jst["step"]) == 5


def test_factored_v_tracks_full_v_scale():
    """Factored vhat must approximate full v for rank-1 gradient fields."""
    oc_f = OptConfig(lr_max=1e-2, schedule="constant", factored_v=True,
                     weight_decay=0.0)
    oc = OptConfig(lr_max=1e-2, schedule="constant", weight_decay=0.0)
    rng = np.random.default_rng(1)
    p = {"w": torch.zeros((8, 6))}
    r = torch.tensor(np.abs(rng.standard_normal((8, 1), dtype=np.float32))
                     + 0.1)
    c = torch.tensor(np.abs(rng.standard_normal((1, 6), dtype=np.float32))
                     + 0.1)
    g = {"w": r * c}                     # rank-1: factorization is exact
    pf, _ = apply_updates(p, g, init_opt(p, oc_f), oc_f)
    pd, _ = apply_updates(p, g, init_opt(p, oc), oc)
    np.testing.assert_allclose(pf["w"].numpy(), pd["w"].numpy(), rtol=1e-4,
                               atol=1e-6)


def test_schedule_warmup_and_decay():
    oc = OptConfig(lr_max=1.0, warmup=10, decay_steps=100, lr_min_ratio=0.1)
    assert float(oc.lr_at(0)) == 0.0
    assert abs(float(oc.lr_at(5)) - 0.5) < 1e-6
    assert abs(float(oc.lr_at(10)) - 1.0) < 1e-6
    assert float(oc.lr_at(100)) <= 0.1 + 1e-6
    assert float(oc.lr_at(250)) >= 0.1 - 1e-6   # floor
    kw = dict(lr_max=3e-4, warmup=5, decay_steps=40, lr_min_ratio=0.1)
    for s in range(0, 60, 3):
        step = torch.tensor(s, dtype=torch.int32)
        assert abs(float(warmup_cosine(step, **kw))
                   - float(j_warmup_cosine(s, **kw))) <= 1e-6 * 3e-4


@given(st.lists(st.floats(-100, 100), min_size=4, max_size=4),
       st.integers(0, 5))
@settings(max_examples=50, deadline=None)
def test_quantize_bounds(vals, _seed):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x).abs()
    assert q.dtype == torch.int8
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_accumulates_unbiased():
    """Sum of decoded messages tracks sum of inputs within one quantum:
    the EF residual never exceeds half a quantization step in norm."""
    rng = np.random.default_rng(3)
    stt = ef_init(torch.zeros(32))
    total_in, total_out = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = torch.tensor(rng.standard_normal(32, dtype=np.float32))
        q, scale, stt = ef_compress(g, stt)
        total_in += g.numpy()
        total_out += dequantize_int8(q, scale).numpy()
    resid = np.abs(total_in - total_out)
    np.testing.assert_allclose(resid, np.abs(stt.err.numpy()), rtol=1e-4,
                               atol=1e-4)
    assert resid.max() < 0.1


RANK = textwrap.dedent("""
    import sys
    import torch
    import torch.distributed as dist
    from repro_torch.optim.compress import EFState, cross_pod_grad_sync
    rank, world, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    dist.init_process_group("gloo", init_method="file://" + path,
                            rank=rank, world_size=world)
    g = torch.full((8,), 1.0 + 2.0 * rank)
    out, st = cross_pod_grad_sync(g, EFState(err=torch.zeros(8)))
    assert torch.allclose(out, torch.full((8,), 2.0), rtol=1e-2), out
    # a constant gradient quantizes exactly: no residual to carry
    assert float(st.err.abs().max()) <= 1e-6, st.err
    dist.destroy_process_group()
    print("RANK_OK", rank)
""")


def test_cross_pod_sync_gloo_world2(tmp_path):
    """int8 EF all-gather sync over a 2-rank gloo group averages the
    ranks' gradients (1 and 3 -> 2), each rank keeping its own residual."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1")
    path = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "2", path],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)
    assert all("RANK_OK" in o for o in outs)


def _same_state(mine, ref, rtol=1e-4):
    """Two train states in the reference's layout: the same leaves, each
    within rtol of the other (scaled by the leaf's largest entry)."""
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(mine))
    for path, want in flat:
        got = mine
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        assert np.shape(got) == want.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(
            got, want, rtol=rtol,
            atol=rtol * float(np.abs(want).max(initial=0.0)),
            err_msg=jax.tree_util.keystr(path))


FACTORED = dict(lr_max=1e-3, warmup=2, decay_steps=10, factored_v=True)


@pytest.fixture(scope="module")
def factored_steps():
    """Both packages' factored train steps for reduced zamba2-1.2b (its
    per-layer norm scales and SSD vectors factor as r (L,), c (d,))."""
    arch = "zamba2-1.2b"
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jstep = jax.jit(j_make_train_step(
        jcfg, JOC(**FACTORED), JTrainConfig(),
        opts=JModelOpts(remat="full", loss_chunk=32)))
    step = make_train_step(cfg, OptConfig(**FACTORED), TrainConfig(),
                           opts=ModelOpts(loss_chunk=32))
    return jcfg, cfg, jstep, step


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_factored_checkpoint_crosses_packages(tmp_path, writer,
                                              factored_steps):
    """A checkpoint with the factored second moment (ROADMAP C1) written
    by either package's trainer after two steps restores in the other,
    and both third steps agree: loss and grad norm within 1e-4
    relative, then the whole state."""
    jcfg, cfg, jstep, step = factored_steps
    kw = FACTORED
    pipe = JTokenPipeline(cfg.vocab_size, 4, 64, seed=0)
    jp = j_init_params(jcfg, jax.random.PRNGKey(3))
    jo = j_init(jp, JOC(**kw))
    params, opt = init_train_state(cfg, OptConfig(**kw),
                                   torch.Generator().manual_seed(9))
    for s in range(2):
        b = pipe.batch_at(s)
        if writer == "reference":
            jp, jo, _ = jstep(jp, jo, {k: jnp.asarray(v)
                                       for k, v in b.items()})
        else:
            params, opt, _ = step(params, opt, {
                k: torch.as_tensor(v) for k, v in b.items()})
    if writer == "reference":
        j_ckpt.save(str(tmp_path), 2, {"params": jp, "opt": jo})
        st, tree, _ = ckpt.restore(str(tmp_path), state_like(params, opt),
                                   device="cpu")
        load_state(params, opt, tree)
    else:
        ckpt.save(str(tmp_path), 2, state_tree(params, opt))
        st, tree, _ = j_ckpt.restore(str(tmp_path), {"params": jp,
                                                     "opt": jo})
        jp, jo = tree["params"], tree["opt"]
    assert st == 2 and int(opt["step"]) == int(jo["step"]) == 2
    b = pipe.batch_at(2)
    jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
    params, opt, m = step(params, opt, {k: torch.as_tensor(v)
                                        for k, v in b.items()})
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            1e-4 * abs(float(jm[key])), key
    _same_state(state_tree(params, opt), {"params": jp, "opt": jo})
