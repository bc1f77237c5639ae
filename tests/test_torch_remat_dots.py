"""remat "dots" (``models/transformer.py``) on the CPU: the port's twin of
the reference's ``jax.checkpoint(policy=dots_with_no_batch_dims_saveable)``.

- A dots step equals the port's remat full step bit for bit (loss, grad
  norm, the first step's gradients, the parameters after 3 steps) in
  every family, at ``scan_groups`` 1 and 2: the forward ops are the same
  and the kept outputs are the values the recompute would make.
- It is within 1e-4 of the reference's dots step for gemma3-1b and
  mamba2-780m: loss and grad norm per step relative, the first step's
  gradients of each leaf's largest, and (gemma3-1b) the parameters after
  3 steps atol and rtol, as tests/test_torch_train.py holds them. Not
  mamba2's parameters: one element of ``blocks.ssm.wo`` has a near-zero
  first gradient whose f32 rounding Adam's first update (lr times its
  sign) carries into the parameters (5.28e-4 off after 3 steps, as far
  under remat full: the reference's dots and full parameters are equal
  there; ROADMAP C).
- What it keeps: per block, the outputs of the products ``layers.dot``
  makes, held against what the reference keeps per layer under "dots"
  and not under "full" (``saved_residuals``), width by width (elements
  per token). Both also keep each block's input (the non-reentrant
  checkpoint's input; the reference's scan carry), under full too.
  Neither keeps a block's last product (the MLP's w2 output, the SSD's
  wo output): it feeds only the residual sum, so the reference's
  backward drops it, and the port does not mark it (torch's selective
  checkpoint keeps what the policy marks, needed or not). The
  reference keeps, besides its products, the outputs of its
  jitted helpers over them: silu of the MLP's w1 output and of the SSD's
  z (the port keeps w1's output and z, of the same widths) and the SSD
  causal conv's shifted inputs (three of d_inner, six of d_state).
- The plan (meta tensors under ``OpStream``) counts the kept outputs,
  and the dry run's operations lose the products the recompute no
  longer runs.
- ``launch/train.py --remat dots`` and ``launch/dryrun.py --remat dots``
  run.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src.ad_checkpoint import saved_residuals

from repro.configs import get_config as j_get_config
from repro.configs import reduced as j_reduced
from repro.models import ModelOpts as JModelOpts
from repro.models import init_params as j_init_params
from repro.models.transformer import loss_fn as j_loss_fn
from repro.optim import OptConfig as JOptConfig
from repro.optim import init_opt as j_init_opt
from repro.train import TrainConfig as JTrainConfig
from repro.train import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.opanalysis import OpStream
from repro_torch.launch.specs import ArchPolicy, plan_train
from repro_torch.models import params_from_jax, params_to_numpy
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, init_opt
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.trainer import compute_grads, init_train_state
from repro_torch.utils import as_tree, tree_leaves

FAMILIES = {"dense": "gemma3-1b", "vlm": "llava-next-mistral-7b",
            "moe": "mixtral-8x7b", "ssm": "mamba2-780m",
            "hybrid": "zamba2-1.2b", "encdec": "seamless-m4t-medium"}
OPT = dict(lr_max=1e-3, warmup=2, decay_steps=10)
PARITY_RTOL = 1e-4
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, step, batch=B, seq=S):
    out = TokenPipeline(cfg.vocab_size, batch, seq, seed=0).batch_at(step)
    if cfg.frontend:
        frames = cfg.frontend_tokens if cfg.frontend == "vision" else seq
        out["frontend"] = FrontendPipeline(cfg.d_model, frames,
                                           seed=0).batch_at(step, batch)
    return out


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _run(cfg, init, remat, groups, steps=3):
    """(per step (loss, grad norm), the first step's gradients, the
    parameters after the last step) of the port's step."""
    opts = T.ModelOpts(remat=remat, scan_groups=groups, loss_chunk=32)
    oc = OptConfig(**OPT)
    params = params_from_jax(cfg, init, device="cpu")
    opt = init_opt(params, oc)
    step = make_train_step(cfg, oc, TrainConfig(), opts=opts)
    grads = compute_grads(params, cfg, _torch(_batch(cfg, 0)),
                          TrainConfig(), opts)[2]
    rows = []
    for s in range(steps):
        params, opt, m = step(params, opt, _torch(_batch(cfg, s)))
        rows.append((float(m["loss"]), float(m["grad_norm"])))
    return rows, tree_leaves(as_tree(grads)), tree_leaves(as_tree(params))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_dots_equals_full_bit_for_bit(family, groups):
    cfg = reduced(get_config(FAMILIES[family]))
    init = params_to_numpy(init_train_state(
        cfg, OptConfig(), torch.Generator().manual_seed(0))[0])
    full, dots = (_run(cfg, init, r, groups) for r in ("full", "dots"))
    assert dots[0] == full[0]
    for got, want in zip(dots[1:], full[1:]):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-780m"])
def test_dots_steps_match_the_references_dots_steps(arch):
    """Three steps of both packages under "dots" from the reference's
    weights: loss and grad norm per step; the first step's gradients;
    gemma3-1b's parameters after the last (module doc)."""
    jcfg, cfg = j_reduced(j_get_config(arch)), reduced(get_config(arch))
    jparams = j_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                             device="cpu")
    b0 = _batch(cfg, 0, 4, 64)
    jgrads = jax.jit(jax.grad(lambda p: j_loss_fn(
        p, jcfg, {k: jnp.asarray(v) for k, v in b0.items()},
        opts=JModelOpts(remat="dots", loss_chunk=32))[0]))(jparams)
    grads = params_to_numpy(compute_grads(
        params, cfg, _torch(b0), TrainConfig(),
        T.ModelOpts(remat="dots", loss_chunk=32))[2])
    for path, want in jax.tree_util.tree_flatten_with_path(jgrads)[0]:
        got = grads
        for key in path:
            got = got[key.key]
        want = np.asarray(want)
        assert np.abs(got - want).max() <= \
            PARITY_RTOL * np.abs(want).max(), jax.tree_util.keystr(path)
    jstep = jax.jit(j_make_train_step(
        jcfg, JOptConfig(**OPT), JTrainConfig(),
        opts=JModelOpts(remat="dots", loss_chunk=32)))
    step = make_train_step(cfg, OptConfig(**OPT), TrainConfig(),
                           opts=T.ModelOpts(remat="dots", loss_chunk=32))
    jopt, opt = j_init_opt(jparams, JOptConfig(**OPT)), init_opt(
        params, OptConfig(**OPT))
    for s in range(3):
        b = _batch(cfg, s, 4, 64)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        params, opt, m = step(params, opt, _torch(b))
        for k in ("loss", "grad_norm"):
            want = float(jm[k])
            assert abs(float(m[k]) - want) <= PARITY_RTOL * abs(want), \
                (s, k, float(m[k]), want)
    if arch != "gemma3-1b":
        return
    mine = params_to_numpy(params)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        got = mine
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, np.asarray(want), rtol=PARITY_RTOL,
                                   atol=PARITY_RTOL,
                                   err_msg=jax.tree_util.keystr(path))


def _reference_kept_widths(arch, batch, seq):
    """Elements per token of what the reference keeps per layer under
    "dots" and not under "full" (its scan's residuals, (L, B, S, ...))."""
    cfg = j_reduced(j_get_config(arch))
    p = j_init_params(cfg, jax.random.PRNGKey(0))
    tok = jnp.zeros((batch, seq), jnp.int32)
    kept = {}
    for remat in ("full", "dots"):
        opts = JModelOpts(remat=remat, loss_chunk=32)
        res = saved_residuals(
            lambda p: j_loss_fn(p, cfg, {"tokens": tok, "labels": tok},
                                opts=opts)[0], p)
        kept[remat] = sorted(
            int(np.prod(a.shape[1:])) // (batch * seq) for a, why in res
            if "argument" not in why and a.ndim > 1
            and a.shape[0] == cfg.num_layers)
    for w in kept["full"]:
        kept["dots"].remove(w)
    return kept["dots"]


def _port_kept_widths(arch, batch, seq, monkeypatch):
    """Elements per token of what the first block's selective checkpoint
    keeps (its caching mode's storage after the forward)."""
    modes = []
    make = T._dots_contexts

    def spy():
        ctx = make()
        modes.append(ctx[0])
        return ctx
    monkeypatch.setattr(T, "_dots_contexts", spy)
    cfg = reduced(get_config(arch))
    params = init_train_state(cfg, OptConfig(),
                              torch.Generator().manual_seed(0))[0]
    tok = torch.zeros((batch, seq), dtype=torch.int32)
    T.loss_fn(params, cfg, {"tokens": tok, "labels": tok},
              opts=T.ModelOpts(remat="dots", loss_chunk=32))
    assert len(modes) == cfg.num_layers           # one per block
    kept = []
    for entries in modes[0].storage.values():
        for e in (entries.values() if isinstance(entries, dict)
                  else entries):
            for w in (e if isinstance(e, (tuple, list)) else (e,)):
                if isinstance(getattr(w, "val", None), torch.Tensor):
                    kept.append(w.val.numel() // (batch * seq))
    return sorted(kept)


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b",
                                  "mamba2-780m"])
def test_kept_products_are_the_references(arch, monkeypatch):
    """The kept widths, per block (module doc for the differences):
    gemma3-1b q, k, v, wo, w1 and w3; mixtral-8x7b q, k, v, wo and the
    router's logits, no expert product (batched over the experts);
    mamba2-780m wz, wx, wB, wC and wdt, the reference's conv shifts
    apart. No block's last product (w2, the SSD's wo, the experts')."""
    cfg = reduced(get_config(arch))
    ref = _reference_kept_widths(arch, 2, 64)
    mine = _port_kept_widths(arch, 2, 64, monkeypatch)
    if cfg.family == "ssm":
        # the reference's jitted pad outputs in its causal conv
        for w in [cfg.d_inner] * 3 + [cfg.ssm_state] * 6:
            ref.remove(w)
    assert mine == sorted(ref)


def _kept_bytes(cfg, tokens):
    """Bytes of the products remat "dots" keeps per step (f32)."""
    if cfg.family == "ssm":
        width = 2 * cfg.d_inner + 2 * cfg.ssm_state + cfg.ssm_heads
    else:
        width = cfg.num_heads * cfg.head_dim + 2 * cfg.num_kv_heads \
            * cfg.head_dim + cfg.d_model
        width += cfg.num_experts if cfg.family == "moe" else 2 * cfg.d_ff
    return cfg.num_layers * tokens * width * 4


@pytest.mark.parametrize("arch", ["gemma3-1b", "mixtral-8x7b",
                                  "mamba2-780m"])
def test_the_plan_counts_the_kept_outputs(arch):
    """On meta tensors under ``OpStream(track_memory=True)`` (the dry
    run's memory model) the storage live after a dots forward exceeds a
    full forward's by exactly the kept products' bytes."""
    cfg = reduced(get_config(arch))
    tok = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    live = {}
    for remat in ("full", "dots"):
        params = T.init_params(cfg, torch.Generator().manual_seed(0)).to(
            "meta")
        for p in params.parameters():
            p.requires_grad_(True)
        with OpStream(track_memory=True) as st:
            # the loss holds the graph, and the graph what it keeps
            loss, _ = T.loss_fn(params, cfg, {"tokens": tok, "labels": tok},
                                opts=T.ModelOpts(remat=remat, loss_chunk=32))
            live[remat] = st.live_bytes
        del loss
    assert live["dots"] - live["full"] == _kept_bytes(cfg, 2 * 64)


def test_the_dry_run_drops_the_kept_products_operations():
    """A planned train step of reduced gemma3-1b at data 1 x model 1: the
    dots plan's operations are the full plan's less the products its
    recompute no longer runs (every kept product; the block's last is
    not kept, and the full recompute stops before it: torch's checkpoint
    ends a recompute at its last saved tensor); the collectives of a
    (2, 2) plan are the full plan's."""
    cfg = reduced(get_config("gemma3-1b"))
    pol = ArchPolicy(loss_chunk=32, param_dtype=torch.float32)
    flops, wire = {}, {}
    for remat in ("full", "dots"):
        opts = T.ModelOpts(remat=remat, loss_chunk=32)
        one = make_mesh_for(1, (1, 1), ("data", "model"))
        plan = plan_train(cfg, one, batch=2, seq=64, policy=pol, opts=opts)
        flops[remat] = dryrun.analyze_plan(plan)["per_device"]["flops"]
        four = make_mesh_for(4, (2, 2), ("data", "model"))
        wire[remat] = dryrun.train_collectives(plan_train(
            cfg, four, batch=4, seq=64, policy=pol, opts=opts)).report()
    d, f = cfg.d_model, cfg.d_ff
    hk = cfg.head_dim * (cfg.num_heads + 2 * cfg.num_kv_heads)
    macs = d * hk + cfg.num_heads * cfg.head_dim * d + 2 * d * f
    assert flops["full"] - flops["dots"] == \
        2 * macs * 2 * 64 * cfg.num_layers
    assert wire["dots"]["count_by_kind"] == wire["full"]["count_by_kind"]
    assert wire["dots"]["bytes_by_kind"] == wire["full"]["bytes_by_kind"]


def test_dryrun_cli_plans_a_dots_cell(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch gemma3-1b --shape
    train_4k --remat dots``: an ok record of its own, with its remat."""
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k",
                        "--remat", "dots", "--out", str(tmp_path)]) == 0
    capsys.readouterr()
    rec = json.loads((tmp_path / "gemma3-1b_train_4k_single_remat-dots"
                      ".json").read_text())
    assert rec["status"] == "ok" and rec["remat"] == "dots"
    assert rec["memory"]["fits_hbm"]


def test_train_cli_takes_remat_dots(tmp_path, capsys):
    """``python -m repro_torch.launch.train --remat dots --reduced
    --device cpu`` for 2 steps: the losses and grad norms of
    ``--remat full`` bit for bit; an unknown policy is refused."""
    from repro_torch.launch.train import main as train_main
    hist = {}
    for remat in ("full", "dots"):
        out = tmp_path / f"{remat}.json"
        assert train_main(["--device", "cpu", "--reduced", "--arch",
                           "gemma3-1b", "--steps", "2", "--batch", "2",
                           "--seq", "32", "--remat", remat,
                           "--metrics-out", str(out)]) == 0
        hist[remat] = [(h["loss"], h["grad_norm"])
                       for h in json.loads(out.read_text())]
    assert hist["dots"] == hist["full"] and len(hist["dots"]) == 2
    with pytest.raises(SystemExit):
        train_main(["--device", "cpu", "--arch", "gemma3-1b", "--remat",
                    "selective"])
    capsys.readouterr()
