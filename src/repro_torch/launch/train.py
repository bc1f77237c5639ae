"""Training driver (the reference's ``launch/train.py`` in torch).

Fault tolerance: the checkpoint/restart supervisor (``--ckpt-dir``) and
the in-step NaN guard; the data pipeline is step-addressed, so a
restored run replays the crashed one's batches. Runs on the card unless
``--device cpu`` (which the reduced configurations make quick):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --reduced --steps 200 --batch 8 --seq 256 --device cpu

The reference's ``--mesh`` (a sharded step over a device mesh) is not a
flag here yet. Its sharding rules exist (``models/sharding.py``; the
planner ``launch/specs.py`` and the dry run ``launch/dryrun.py`` read
them on one process); the sharded step itself, with the expert-parallel
MoE, is ROADMAP.md item 16b.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
from repro_torch.ft.restart import run_with_restarts
from repro_torch.models import transformer as T
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import (TrainConfig, init_train_state,
                                       load_state, make_train_step,
                                       state_like, state_tree)
from repro_torch.utils import resolve_device, to_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return ap.parse_args(argv)


def build(args):
    """(cfg, oc, step_fn, pipe, fpipe) for the parsed flags."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opts = T.ModelOpts(remat=args.remat, loss_chunk=args.loss_chunk)
    oc = OptConfig(lr_max=args.lr, warmup=args.warmup,
                   decay_steps=args.steps)
    tc = TrainConfig(grad_accum=args.grad_accum)
    step_fn = make_train_step(cfg, oc, tc, opts=opts)
    pipe = TokenPipeline(cfg.vocab_size, args.batch, args.seq,
                         seed=args.seed)
    fpipe = None
    if cfg.frontend == "vision":
        fpipe = FrontendPipeline(cfg.d_model, cfg.frontend_tokens,
                                 seed=args.seed)
    elif cfg.frontend == "audio":
        fpipe = FrontendPipeline(cfg.d_model, args.seq, seed=args.seed)
    return cfg, oc, step_fn, pipe, fpipe


def train(args, *, on_step=None, fail_injector=None) -> dict:
    """The training loop of :func:`main`: supervised with checkpoints
    under ``--ckpt-dir``, plain otherwise. ``on_step(step, metrics)``
    runs after each step (before the log line); ``fail_injector(step)``
    may raise to simulate a failure (supervised runs only). Returns
    {"history", "step", "params", "opt", "restarts", "seconds"}."""
    device = resolve_device(args.device)
    cfg, oc, step_fn, pipe, fpipe = build(args)
    history = []

    def batch_at(step):
        b = {k: to_device(v, device) for k, v in pipe.batch_at(step).items()}
        if fpipe is not None:
            b["frontend"] = to_device(fpipe.batch_at(step, args.batch),
                                      device)
        return b

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return 0, init_train_state(cfg, oc, gen)

    def run_step(step, state):
        params, opt = state
        params, opt, m = step_fn(params, opt, batch_at(step))
        if on_step is not None:
            on_step(step, m)
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(m["grad_norm"]),
                            "skipped": int(m["skipped"])})
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(m['grad_norm']):.3f}", flush=True)
        return params, opt

    t0 = time.time()
    restarts = 0
    if args.ckpt_dir:
        def restore_state(latest):
            _, (params, opt) = init_state()
            st, tree, _ = ckpt.restore(args.ckpt_dir,
                                       state_like(params, opt),
                                       step=latest, device=device)
            load_state(params, opt, tree)
            return st, (params, opt)

        def save_state(step, state):
            ckpt.save(args.ckpt_dir, step, state_tree(*state))

        step, state, stats = run_with_restarts(
            init_state=init_state, restore_state=restore_state,
            run_step=run_step, save_state=save_state,
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, fail_injector=fail_injector)
        restarts = stats.restarts
        print(f"done at step {step}; restarts={restarts}")
    else:
        step, state = init_state()
        while step < args.steps:
            state = run_step(step, state)
            step += 1
        dt = time.time() - t0
        print(f"done: {args.steps} steps in {dt:.1f}s "
              f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    return {"history": history, "step": step, "params": state[0],
            "opt": state[1], "restarts": restarts,
            "seconds": time.time() - t0}


def main(argv=None):
    args = parse_args(argv)
    out = train(args)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(out["history"], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
