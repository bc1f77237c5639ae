"""Reference side of the sharded-training parity tests
(``tests/test_torch_train_mesh*.py``): the reference's train step on a
mesh of forced host devices, as its ``launch/train.py --mesh`` means it.

    XLA_FLAGS="--xla_force_host_platform_device_count=4 \\
        --xla_backend_optimization_level=0" \\
        python tests/torch_train_mesh_ref.py OUT.pkl CASES_JSON

(The tests compile each case's step once and run it three times: LLVM's
optimisation level 0 compiles it in two thirds of the time; XLA's own
passes and the step's meaning are the same.)

CASES_JSON is a list of cases, each {"arch", "mesh" (a shape over
("data", "model"), or ("pod", "data", "model") for three entries),
"steps", "factored", "batch", "seq"}; "mesh" null runs the unsharded
step. The reference's own ``--mesh`` does not run on jax 0.9
(``jax.make_mesh`` makes Explicit axes, which ``shard_act`` refuses, and
its step is not called under a mesh), so the step is built here with
Auto axes and called under ``jax.set_mesh``. Writes, per case: the
initial parameters (numpy, the reference's stacked layout: the
reference's ``PRNGKey(0)`` draw), each step's loss, grad norm, lb_loss
and drop_frac, and the parameters after the last step.
"""
from __future__ import annotations

import json
import pickle
import sys

import jax
import numpy as np

from repro.configs import get_config, reduced
from repro.data import FrontendPipeline, TokenPipeline
from repro.models import ModelOpts, init_params
from repro.models.sharding import make_rules
from repro.optim import OptConfig, init_opt
from repro.train import TrainConfig, make_train_step

# the parity tests' setup (tests/torch_train_mesh_ranks.py has the same)
OPT = dict(lr_max=1e-3, warmup=2, decay_steps=10)
LOSS_CHUNK = 32


def batch_at(cfg, batch: int, seq: int, step: int) -> dict:
    """The step's global batch as numpy: tokens, labels, and the
    frontend's input where the family has one (launch/train.py's)."""
    out = TokenPipeline(cfg.vocab_size, batch, seq, seed=0).batch_at(step)
    if cfg.frontend == "vision":
        out["frontend"] = FrontendPipeline(
            cfg.d_model, cfg.frontend_tokens, seed=0).batch_at(step, batch)
    elif cfg.frontend == "audio":
        out["frontend"] = FrontendPipeline(cfg.d_model, seq,
                                           seed=0).batch_at(step, batch)
    return out


def run_case(case: dict) -> dict:
    cfg = reduced(get_config(case["arch"]))
    oc = OptConfig(**OPT, factored_v=bool(case.get("factored")))
    opts = ModelOpts(remat="full", loss_chunk=LOSS_CHUNK)
    rules, mesh = None, None
    if case.get("mesh"):
        shape = tuple(case["mesh"])
        axes = ("data", "model") if len(shape) == 2 else \
            ("pod", "data", "model")
        mesh = jax.make_mesh(shape, axes, axis_types=(
            jax.sharding.AxisType.Auto,) * len(shape))
        rules = make_rules(cfg, mesh, kind="train")
    step = jax.jit(make_train_step(cfg, oc, TrainConfig(), rules=rules,
                                   opts=opts))
    params = init_params(cfg, jax.random.PRNGKey(0))
    init = jax.tree_util.tree_map(np.asarray, params)
    opt = init_opt(params, oc)
    rows = []
    for s in range(case["steps"]):
        b = {k: jax.numpy.asarray(v) for k, v in
             batch_at(cfg, case["batch"], case["seq"], s).items()}
        if mesh is not None:
            with jax.set_mesh(mesh):
                params, opt, m = step(params, opt, b)
        else:
            params, opt, m = step(params, opt, b)
        rows.append({k: float(m[k]) for k in (
            "loss", "grad_norm", "lb_loss", "drop_frac") if k in m})
    return {"init": init, "steps": rows,
            "final": jax.tree_util.tree_map(np.asarray, params)}


def main(argv) -> int:
    out, cases = argv[0], json.loads(argv[1])
    res = [run_case(c) for c in cases]
    with open(out, "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
