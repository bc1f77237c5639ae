"""Training driver (the reference's ``launch/train.py`` in torch).

Fault tolerance: the checkpoint/restart supervisor (``--ckpt-dir``) and
the in-step NaN guard; the data pipeline is step-addressed, so a
restored run replays the crashed one's batches. Runs on the card unless
``--device cpu`` (which the reduced configurations make quick):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --reduced --steps 200 --batch 8 --seq 256 --device cpu

``--mesh D,M`` (or ``P,D,M``) runs the sharded step (``train/trainer.py``
``make_train_step(mesh=)``: FSDP over the data axes, tensor parallelism
over "model" for every family — attention heads, d_ff and the vocab,
the SSD's d_inner and heads, the encoder and the cross-attention — and
the expert-parallel MoE) with one process per rank over
``torch.distributed``: ``nccl`` on
the card, ``gloo`` with ``--device cpu``. The rendezvous is explicit:
``--init-method`` (``file://...`` or ``tcp://127.0.0.1:PORT``), or
``MASTER_ADDR`` and ``MASTER_PORT``; each process's ``RANK`` and
``WORLD_SIZE`` (else 0 and 1), as ``torchrun`` sets them::

  torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch mixtral-8x7b --reduced --mesh 2,2 --device cpu

Every rank builds the same parameters from ``--seed`` and keeps its
shard; rank 0 prints the per-step lines, writes ``--metrics-out`` and
the checkpoints (the full arrays, the one-device layout: a checkpoint
crosses between meshes, one device and the reference); a restore reads
the file on every rank and keeps each rank's shard. On a card only a
world of one runs here (one card per machine; NCCL takes one rank per
GPU).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs.registry import get_config, reduced
from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
from repro_torch.ft.restart import run_with_restarts
from repro_torch.launch.mesh import init_train_group, make_train_mesh
from repro_torch.models import transformer as T
from repro_torch.models.convert import shard_params
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import (TrainConfig, gather_state,
                                       init_train_state, load_state,
                                       make_train_step, shard_opt,
                                       state_like, state_tree, trainable)
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
    ap.add_argument("--remat", default="full",
                    choices=T.REMAT,
                    help="per-block checkpoint under grad: none, full "
                         "(keep each block's input, recompute the rest) "
                         "or dots (keep also the outputs of the products "
                         "with no batch dimension, as the reference's "
                         "dots_with_no_batch_dims_saveable)")
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default="")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default="",
                    help="D,M (data, model) or P,D,M: the sharded step "
                         "(FSDP over the data axes, tensor parallelism "
                         "over model, every family), one process per rank")
    ap.add_argument("--init-method", default=None,
                    help="the ranks' rendezvous (file:// or tcp://; the "
                         "rank and world from RANK and WORLD_SIZE, else 0 "
                         "and 1); default MASTER_ADDR and MASTER_PORT")
    return ap.parse_args(argv)


def mesh_shape(args) -> tuple:
    return tuple(int(x) for x in args.mesh.split(",")) if args.mesh else ()


def build(args, mesh=None):
    """(cfg, oc, step_fn, pipe, fpipe) for the parsed flags; ``mesh``: the
    training mesh of ``--mesh`` (the step is then one rank's)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    opts = T.ModelOpts(remat=args.remat, loss_chunk=args.loss_chunk)
    oc = OptConfig(lr_max=args.lr, warmup=args.warmup,
                   decay_steps=args.steps)
    tc = TrainConfig(grad_accum=args.grad_accum)
    step_fn = make_train_step(cfg, oc, tc, opts=opts, mesh=mesh)
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
    under ``--ckpt-dir``, plain otherwise; with ``--mesh`` one rank's
    share (the process group started here if it is not yet, and ended
    here then). ``on_step(step, metrics)`` runs after each step (before
    the log line); ``fail_injector(step)`` may raise to simulate a
    failure (supervised runs only). Returns {"history", "step",
    "params", "opt", "restarts", "seconds", "rank"} (on a mesh the
    rank's shards)."""
    device = resolve_device(args.device)
    shape, own_group = mesh_shape(args), False
    mesh = None
    if shape:
        if not dist.is_initialized():
            init_train_group(device, init_method=args.init_method)
            own_group = True
        mesh = make_train_mesh(shape, device=device)
    try:
        return _train(args, device, mesh, on_step, fail_injector)
    finally:
        if own_group:
            dist.destroy_process_group()


def _train(args, device, mesh, on_step, fail_injector) -> dict:
    cfg, oc, step_fn, pipe, fpipe = build(args, mesh)
    lead = mesh is None or mesh.rank == 0
    history = []

    def batch_at(step):
        b = {k: to_device(v, device) for k, v in pipe.batch_at(step).items()}
        if fpipe is not None:
            b["frontend"] = to_device(fpipe.batch_at(step, args.batch),
                                      device)
        return b

    def shard(params, opt):
        """A full state -> this rank's shards (the full one is dropped)."""
        if mesh is None:
            return params, opt
        par = step_fn.par
        p = trainable(shard_params(params, par.rules, mesh, cfg))
        return p, shard_opt(par, oc, p, opt)

    def init_state():
        gen = torch.Generator(device=device).manual_seed(args.seed)
        return 0, shard(*init_train_state(cfg, oc, gen))

    def run_step(step, state):
        params, opt = state
        params, opt, m = step_fn(params, opt, batch_at(step))
        if on_step is not None:
            on_step(step, m)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
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
            gen = torch.Generator(device=device).manual_seed(args.seed)
            params, opt = init_train_state(cfg, oc, gen)
            st, tree, _ = ckpt.restore(args.ckpt_dir,
                                       state_like(params, opt),
                                       step=latest, device=device)
            load_state(params, opt, tree)
            return st, shard(params, opt)

        def save_state(step, state):
            full = state if mesh is None else gather_state(
                step_fn.par, oc, *state)
            if lead:
                ckpt.save(args.ckpt_dir, step, state_tree(*full))
            if mesh is not None:
                dist.barrier()

        step, state, stats = run_with_restarts(
            init_state=init_state, restore_state=restore_state,
            run_step=run_step, save_state=save_state,
            total_steps=args.steps, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, fail_injector=fail_injector)
        restarts = stats.restarts
        if lead:
            print(f"done at step {step}; restarts={restarts}")
    else:
        step, state = init_state()
        while step < args.steps:
            state = run_step(step, state)
            step += 1
        dt = time.time() - t0
        if lead:
            print(f"done: {args.steps} steps in {dt:.1f}s "
                  f"({args.steps * args.batch * args.seq / dt:.0f} tok/s)")
    return {"history": history, "step": step, "params": state[0],
            "opt": state[1], "restarts": restarts,
            "seconds": time.time() - t0,
            "rank": 0 if mesh is None else mesh.rank}


def main(argv=None):
    args = parse_args(argv)
    out = train(args)
    if args.metrics_out and out["rank"] == 0:
        with open(args.metrics_out, "w") as f:
            json.dump(out["history"], f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
