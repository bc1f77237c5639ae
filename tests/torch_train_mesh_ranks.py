"""Rank body of tests/test_torch_train_mesh*.py: one ``gloo`` rank of a
training mesh on the CPU, running the cases its parent wrote.

    python tests/torch_train_mesh_ranks.py RANK WORLD DIR

``DIR/cases.pkl`` holds a list of cases, each a dict: "name", "arch"
(reduced), "mesh" (a shape over ("data", "model")), "steps", "batch",
"seq", "factored", "init" (the reference's parameter tree as numpy),
and optionally "remat" ("full" by default), "scan_groups",
"grad_accum", "save_at" (write a
checkpoint to ``DIR/<name>_ckpt`` after that many steps), "restore" (a
checkpoint directory to start from), "stats_step" (the step whose
collectives are kept) and "grads_step" (the step whose gradients,
gathered, rank 0 keeps). The rank joins the world through
``DIR/rendezvous``, builds each case's mesh from it, and writes
``DIR/rank<RANK>.pkl``: per case each step's metrics, and on rank 0 the
gathered parameters after the last step and the collectives of
``stats_step`` by tag.

    python tests/torch_train_mesh_ranks.py one DIR

runs the port's one-device step of each case in ``DIR/cases.pkl`` and
writes ``DIR/one.pkl``. With ``TRAIN_MESH_F64=1`` in the environment
either runs in float64 (:func:`promote_f64`). The rank body imports
torch, numpy and the port only; the parent's helpers at the end
(spawning the ranks and the reference's ``tests/torch_train_mesh_ref.py``,
the one-device runs, the gates) import the reference where they need
it.
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch


def promote_f64() -> None:
    """Run every float32 computation of the port in float64, for this
    process: the port names float32 where it computes in it (``.float()``,
    ``torch.float32``, defaults bound when its modules load), so these
    names are rebound before the port is imported. The f64 gates use it
    to tell a fault of a cut from f32 rounding."""
    torch.float32 = torch.float = torch.float64
    torch.Tensor.float = lambda self, *a, **k: self.double(*a, **k)
    torch.set_default_dtype(torch.float64)


if os.environ.get("TRAIN_MESH_F64") == "1":
    promote_f64()

from repro_torch import checkpoint as ckpt  # noqa: E402 - after promote_f64
from repro_torch.configs import get_config, reduced
from repro_torch.data.pipeline import FrontendPipeline, TokenPipeline
from repro_torch.launch.mesh import init_train_group, make_train_mesh
from repro_torch.models import params_from_jax
from repro_torch.models.convert import (param_axes, params_to_numpy,
                                        shard_params, stacked, uncut)
from repro_torch.models.transformer import ModelOpts
from repro_torch.optim import OptConfig, init_opt
from repro_torch.train import TrainConfig, make_train_step
from repro_torch.train.parallel import STATS
from repro_torch.train.trainer import (compute_grads, gather_state,
                                       load_state, shard_opt, state_like,
                                       state_tree, trainable)
from repro_torch.utils import tree_map

# the setup of tests/torch_train_mesh_ref.py
OPT = dict(lr_max=1e-3, warmup=2, decay_steps=10)
LOSS_CHUNK = 32
KEYS = ("loss", "grad_norm", "lb_loss", "drop_frac")


def batch_at(cfg, batch: int, seq: int, step: int) -> dict:
    out = TokenPipeline(cfg.vocab_size, batch, seq, seed=0).batch_at(step)
    if cfg.frontend == "vision":
        out["frontend"] = FrontendPipeline(
            cfg.d_model, cfg.frontend_tokens, seed=0).batch_at(step, batch)
    elif cfg.frontend == "audio":
        out["frontend"] = FrontendPipeline(cfg.d_model, seq,
                                           seed=0).batch_at(step, batch)
    # floats in the default dtype: float64 under promote_f64
    return {k: torch.as_tensor(v).to(torch.get_default_dtype())
            if v.dtype.kind == "f" else torch.as_tensor(v)
            for k, v in out.items()}


def setup(case):
    cfg = reduced(get_config(case["arch"]))
    oc = OptConfig(**OPT, factored_v=bool(case.get("factored")))
    opts = ModelOpts(remat=case.get("remat", "full"), loss_chunk=LOSS_CHUNK,
                     scan_groups=case.get("scan_groups", 1))
    return cfg, oc, opts


def run_case(case: dict, out_dir: Path, rank: int) -> dict:
    cfg, oc, opts = setup(case)
    mesh = make_train_mesh(case["mesh"], device="cpu")
    step_fn = make_train_step(
        cfg, oc, TrainConfig(grad_accum=case.get("grad_accum", 1)),
        opts=opts, mesh=mesh)
    par = step_fn.par
    full = params_from_jax(cfg, case["init"], device="cpu")
    params = trainable(shard_params(full, par.rules, mesh, cfg))
    opt = shard_opt(par, oc, params, init_opt(full, oc))
    start = 0
    if case.get("restore"):
        like = state_like(full, init_opt(full, oc))
        start, tree, _ = ckpt.restore(case["restore"], like, device="cpu")
        load_state(full, opt_full := init_opt(full, oc), tree)
        params = trainable(shard_params(full, par.rules, mesh, cfg))
        opt = shard_opt(par, oc, params, opt_full)
    restored = None
    if case.get("restore"):                  # collective: every rank
        # copies: at world 1 the gathered state is the live tensors
        restored = state_tree(*gather_state(par, oc, params, opt),
                              leaf=lambda t: t.detach().numpy().copy())
        restored = restored if rank == 0 else None
    rows = []
    stats = grads = None
    for s in range(start, case["steps"]):
        if s == case.get("save_at"):
            save(case, par, oc, params, opt, out_dir, s, rank)
        if s == case.get("grads_step"):
            _, _, g = compute_grads(
                params, cfg, batch_at(cfg, case["batch"], case["seq"], s),
                TrainConfig(), opts, par)
            grads = stacked(tree_map(lambda t, a: uncut(t, a, mesh), g,
                                     param_axes(cfg, par.rules)))
        STATS.reset()
        params, opt, m = step_fn(params, opt,
                                 batch_at(cfg, case["batch"], case["seq"], s))
        if s == case.get("stats_step", -1):
            stats = {t: STATS.rows(t) for t in
                     ("step", "scalar", "factored")}
        rows.append({k: float(m[k]) for k in KEYS if k in m})
    full_p, full_opt = gather_state(par, oc, params, opt)
    res = {"steps": rows, "stats": stats, "restored": restored,
           "grads": grads}
    if rank == 0:
        res["final"] = params_to_numpy(full_p)
        res["opt"] = state_tree(full_p, full_opt)["opt"]
    return res


def save(case, par, oc, params, opt, out_dir, step, rank) -> None:
    """Rank 0 writes the full state in the one-device layout."""
    full_p, full_opt = gather_state(par, oc, params, opt)
    if rank == 0:
        ckpt.save(str(out_dir / f"{case['name']}_ckpt"), step,
                  state_tree(full_p, full_opt))
    torch.distributed.barrier()


def main(argv) -> int:
    if argv[0] == "one":
        return main_one(Path(argv[1]))
    rank, world, out = int(argv[0]), int(argv[1]), Path(argv[2])
    torch.manual_seed(0)
    torch.set_num_threads(1)
    init_train_group("cpu", init_method=f"file://{out / 'rendezvous'}",
                     rank=rank, world=world, timeout_s=300)
    with open(out / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    results = {}
    try:
        for case in cases:
            results[case["name"]] = run_case(case, out, rank)
    except Exception:                 # noqa: BLE001 - the log says why
        traceback.print_exc()
        return 1
    finally:
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(results, f)
    torch.distributed.destroy_process_group()
    return 0


def main_one(out: Path) -> int:
    """The one-device step of every case in ``out/cases.pkl``, by arch,
    to ``out/one.pkl``."""
    torch.manual_seed(0)
    torch.set_num_threads(1)
    with open(out / "cases.pkl", "rb") as f:
        cases = pickle.load(f)
    res = {c["arch"]: one_device(c, c["init"]) for c in cases}
    with open(out / "one.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


# ---------------------------------------------------------------------------
# The parent's side: spawn the ranks and the reference, read what they wrote
# ---------------------------------------------------------------------------
REPO = Path(__file__).resolve().parent.parent
#: seconds the ranks and the reference may take (the suite runs beside
#: other files on a shared CPU)
TIMEOUT_S = 600


def start_ranks(cases: list, world: int, out: Path, f64=False) -> list:
    """Write ``cases`` to ``out`` and start ``world`` rank processes
    (their logs in ``out/rank<r>.log``); ``world`` 0: one process of the
    one-device steps (``out/one.log``). ``f64``: in float64."""
    import subprocess
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", TRAIN_MESH_F64="1" if f64 else "0")
    argvs = ([[str(r), str(world)] for r in range(world)] if world
             else [["one"]])
    procs = []
    for argv in argvs:
        log = open(out / f"{'rank' if world else ''}{argv[0]}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__)), *argv, str(out)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def start_reference(cases: list, out: Path):
    """Start tests/torch_train_mesh_ref.py on 4 forced host devices for
    ``cases`` (json-able dicts); its result goes to ``out``."""
    import json
    import os
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_backend_optimization_level=0")
    log = open(str(out) + ".log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(REPO / "tests" / "torch_train_mesh_ref.py"),
         str(out), json.dumps(cases)], cwd=REPO, env=env, stdout=log,
        stderr=subprocess.STDOUT)
    log.close()
    return proc


def finish(procs: list, logs: list) -> None:
    """Wait for every process; kill the rest at the deadline; raise with
    the failed ones' logs."""
    import time
    deadline = time.monotonic() + TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [i for i, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise AssertionError("\n".join(Path(logs[i]).read_text()[-4000:]
                                       for i in bad))


def rank_results(out: Path, world: int) -> list:
    res = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


def wire_of(rows: list, sizes: dict) -> dict:
    """A rank's counted collectives (``STATS.rows``) through the dry run's
    ring formulas: its ``bytes_by_kind`` and ``count_by_kind``."""
    from repro_torch.launch.dryrun import _Wire
    w = _Wire(sizes)
    ring = {"all-gather": w.ring_gather, "reduce-scatter": w.ring_scatter,
            "all-reduce": w.ring_reduce}
    for kind, axis, ranks, nbytes, calls in rows:
        ring[kind](axis, ranks, nbytes / calls, calls)
    rep = w.report()
    return {"bytes_by_kind": rep["bytes_by_kind"],
            "count_by_kind": rep["count_by_kind"]}


def dry_run_wire(case: dict) -> dict:
    """``launch/dryrun.py``'s collectives for the case's cell: the reduced
    arch on a planning mesh of the case's shape, f32 parameters and
    activations, its batch, its remat, the loss chunk."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.specs import ArchPolicy, plan_train
    cfg, _, opts = setup(case)
    shape = tuple(case["mesh"])
    mesh = make_mesh_for(int(np.prod(shape)), shape, ("data", "model"))
    pol = ArchPolicy(loss_chunk=LOSS_CHUNK, param_dtype=torch.float32,
                     scan_groups=opts.scan_groups,
                     grad_accum=case.get("grad_accum", 1))
    plan = plan_train(cfg, mesh, batch=case["batch"], seq=case["seq"],
                      policy=pol, opts=opts)
    rep = dryrun.train_collectives(plan).report()
    return {"bytes_by_kind": rep["bytes_by_kind"],
            "count_by_kind": rep["count_by_kind"]}


# ---------------------------------------------------------------------------
# The tests' runs and gates
# ---------------------------------------------------------------------------
#: loss and grad norm against the reference's step, relative; parameters
#: (atol and rtol), as tests/test_torch_train.py
PARITY_RTOL = 1e-4
#: lb_loss and drop_frac against the reference's, absolute
MOE_ATOL = 1e-6


def reference_init(arch):
    """The reference's ``PRNGKey(0)`` parameters of the reduced arch."""
    import jax
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import init_params as j_init_params
    cfg = j_reduced(j_get_config(arch))
    return jax.tree_util.tree_map(
        np.asarray, j_init_params(cfg, jax.random.PRNGKey(0)))


def one_device(case, init) -> dict:
    """The port's unsharded step on the same weights and batches: each
    step's metrics, the parameters after the last, and the gradients of
    ``case["grads_step"]`` where it has one."""
    cfg, oc, opts = setup(case)
    params = trainable(params_from_jax(cfg, init, device="cpu"))
    opt = init_opt(params, oc)
    step = make_train_step(cfg, oc, TrainConfig(), opts=opts)
    rows, grads = [], None
    for s in range(case["steps"]):
        batch = batch_at(cfg, case["batch"], case["seq"], s)
        if s == case.get("grads_step"):
            grads = stacked(compute_grads(params, cfg, batch, TrainConfig(),
                                          opts)[2])
        params, opt, m = step(params, opt, batch)
        rows.append({k: float(m[k]) for k in KEYS if k in m})
    return {"steps": rows, "final": params_to_numpy(params), "grads": grads}


def _f64(init):
    """The parameter tree with its float32 arrays in float64."""
    if isinstance(init, dict):
        return {k: _f64(v) for k, v in init.items()}
    if isinstance(init, (list, tuple)):
        return type(init)(_f64(v) for v in init)
    return init.astype(np.float64) if init.dtype == np.float32 else init


def run_all(tmp, entries: dict, case: dict, extra=(), f64=False) -> dict:
    """``entries`` ({name: (arch, mesh)}) on the reference (a process
    per case: their jit compiles dominate) and on gloo worlds of each
    mesh's size, all at once, with ``case``'s other keys; ``extra``:
    rank-only cases (dicts with a name, arch and mesh). Meanwhile the
    port's one-device steps of every arch run here. Returns {"ref":
    {name: reference result}, "got": {name: rank 0's result},
    "one_device": {arch: one_device(...)}}; with ``f64`` also "got64"
    and "one64", the entries' mesh and one-device runs in float64 (their
    own processes, beside the others)."""
    archs = sorted({a for a, _ in entries.values()}
                   | {e["arch"] for e in extra})
    inits = {a: reference_init(a) for a in archs}
    ref_cases = [dict(arch=a, mesh=list(m), steps=case["steps"],
                      batch=case["batch"], seq=case["seq"],
                      factored=case.get("factored", False))
                 for a, m in entries.values()]
    parts = [[c] for c in ref_cases]
    outs = [tmp / f"ref{i}.pkl" for i in range(len(parts))]
    procs = [start_reference(c, o) for c, o in zip(parts, outs)]
    logs = [str(o) + ".log" for o in outs]
    worlds = {}
    for n, (a, m) in entries.items():
        worlds.setdefault(int(np.prod(m)), []).append(
            dict(case, name=n, arch=a, mesh=list(m), init=inits[a]))
    for e in extra:
        worlds.setdefault(int(np.prod(e["mesh"])), []).append(
            dict(case, init=inits[e["arch"]], **e))
    for world, cases in worlds.items():
        procs += start_ranks(cases, world, tmp / f"w{world}")
        logs += [str(tmp / f"w{world}" / f"rank{r}.log")
                 for r in range(world)]
    worlds64 = {}
    if f64:
        for n, (a, m) in entries.items():
            worlds64.setdefault(int(np.prod(m)), []).append(
                dict(case, name=n, arch=a, mesh=list(m),
                     init=_f64(inits[a])))
        worlds64[0] = [dict(case, arch=a, init=_f64(inits[a]))
                       for a in sorted({a for a, _ in entries.values()})]
        for world, cases in worlds64.items():
            procs += start_ranks(cases, world, tmp / f"f64w{world}", f64=True)
            logs += [str(tmp / f"f64w{world}" / f"rank{r}.log")
                     for r in range(world)] or [str(tmp / "f64w0/one.log")]
    alone = {a: one_device(dict(case, arch=a), inits[a]) for a in archs}
    finish(procs, logs)
    ref = []
    for o in outs:
        with open(o, "rb") as f:
            ref += pickle.load(f)
    got = {}
    for world in worlds:
        got.update(rank_results(tmp / f"w{world}", world)[0])
    res = {"ref": dict(zip(entries, ref)), "got": got, "one_device": alone}
    if f64:
        res["got64"] = {}
        for world in worlds64:
            if world:
                res["got64"].update(rank_results(tmp / f"f64w{world}",
                                                 world)[0])
        with open(tmp / "f64w0" / "one.pkl", "rb") as f:
            res["one64"] = pickle.load(f)
    return res


def close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), (what, got, want)


def check_steps(got, ref, rtol=PARITY_RTOL):
    assert len(got) == len(ref)
    for s, (g, r) in enumerate(zip(got, ref)):
        for k in r:
            if k in ("lb_loss", "drop_frac"):
                assert abs(g[k] - r[k]) <= MOE_ATOL, (s, k, g[k], r[k])
            else:
                close(g[k], r[k], rtol, f"step {s} {k}")


def _leaves(tree, *others, path=""):
    """(path, leaf, *the others' leaves) over nested dicts and lists."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], *(o[k] for o in others),
                               path=f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, *(o[i] for o in others),
                               path=f"{path}/{i}")
    else:
        yield (path, tree, *others)


def check_grads(got, want, rtol=PARITY_RTOL) -> list:
    """Every leaf's gradient within ``rtol`` of the largest |gradient| of
    the leaf in ``want`` (the rounding of a sum's order stays below it;
    a missing or doubled sum over an axis does not). Returns the
    elements whose two gradients differ in sign: [(path, index, got,
    want, the leaf's largest |want|)]."""
    flips = []
    for path, g, w in _leaves(got, want):
        g = np.asarray(g)
        top = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= rtol * top, (path, err)
        for i in zip(*np.nonzero(np.sign(g) != np.sign(w))):
            flips.append((path, tuple(int(x) for x in i), float(g[i]),
                          float(w[i]), top))
    return flips


def check_params(got, want, alone=None):
    """Every leaf within 1e-4 (atol and rtol) of the reference's, or no
    farther from it than the port's one-device parameters (``alone``)
    are, plus 1e-5: where the one-device port's own Adam steps amplify a
    near-zero gradient's rounding past the bound, the mesh may add no
    more than 1e-5 to it."""
    for path, w, g, a in _leaves(want, got,
                                 want if alone is None else alone):
        bound = np.maximum(PARITY_RTOL + PARITY_RTOL * np.abs(w),
                           np.abs(np.asarray(a) - w) + 1e-5)
        err = np.abs(np.asarray(g) - w)
        i = np.unravel_index(int(np.argmax(err - bound)), err.shape)
        assert (err <= bound).all(), (path, float(err.max()), i,
                                      float(np.asarray(g)[i]), float(w[i]),
                                      float(np.asarray(a)[i]))


def check_collectives(stats: dict, case: dict) -> dict:
    """A rank's step collectives (tag "step") through the ring formulas
    equal the dry run's for the case's cell, kind for kind; returns the
    scalar reductions' calls by (kind, axis)."""
    import pytest
    sizes = {"data": case["mesh"][0], "model": case["mesh"][1]}
    want = dry_run_wire(case)
    wire = wire_of(stats["step"], sizes)
    assert wire["count_by_kind"] == want["count_by_kind"]
    assert wire["bytes_by_kind"] == pytest.approx(want["bytes_by_kind"],
                                                  rel=1e-12)
    return {(k, a): c for k, a, _, _, c in stats["scalar"]}


#: the f64 gates: the mesh against the port's one-device step, both in
#: float64 (``run_all(f64=True)``): loss and grad norm (relative) and the
#: first step's gradients (relative to the leaf's largest) within
#: F64_RTOL, the parameters after the last step within F64_ATOL. Set
#: from the readings of mamba2-780m, zamba2-1.2b and seamless-m4t-medium
#: (reduced) at (1, 2) and (2, 2), the worst of the six: steps 1.40e-14,
#: gradients 9.29e-15, parameters 4.77e-13 (zamba2). In f32 the same
#: runs read steps 1.02e-5, gradients 7.55e-6, parameters 3.65e-4
#: (zamba2 at (1, 2): one element's first gradient, -4.63e-7 in f64
#: against a leaf's largest of 1.2, rounds to +2.06e-7 on the mesh and
#: -8.97e-7 on one device, and Adam's first step, lr times the sign,
#: carries the difference into the parameters)
F64_RTOL = 1e-10
F64_ATOL = 1e-9


def check_close(got, want, atol):
    """Every leaf of ``got`` within ``atol`` of ``want``'s."""
    for path, g, w in _leaves(got, want):
        err = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert err <= atol, (path, err)


def check_dots(runs, name: str, full: str, case: dict) -> None:
    """Rank-only case ``name`` (remat "dots") against case ``full`` (the
    same mesh, remat full): every step's metrics and the parameters
    after the last step equal bit for bit, and its collectives equal
    the dry run's for the dots cell."""
    got, want = runs["got"][name], runs["got"][full]
    assert got["steps"] == want["steps"]
    for path, g, w in _leaves(got["final"], want["final"]):
        assert np.array_equal(g, w), path
    check_collectives(got["stats"], case)


def one_torch_thread():
    """A module fixture (autouse) for a test file of the mesh: one
    intra-op thread in the parent, whose one-device steps run beside the
    rank processes, so that the suite's workers do not oversubscribe
    the cores."""
    import pytest

    @pytest.fixture(scope="module", autouse=True)
    def _one_torch_thread():
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)
    return _one_torch_thread


def gate_tests(entries: dict, case: dict, f64: bool = False,
               extra=()) -> dict:
    """The mesh parity tests of one file, for its module's namespace: a
    module fixture ``runs`` (:func:`run_all` of ``entries`` with
    ``case``'s keys, and the rank-only cases ``extra``) and, parametrized over ``entries``,

      test_steps_equal_the_references_sharded_step   (rtol 1e-4)
      test_steps_equal_the_ports_one_device_step
      test_parameters_after_three_steps
      test_collectives_equal_the_dry_runs

    (and one torch thread in the parent: :func:`one_torch_thread`).
    Without ``f64`` the one-device step is held in f32 at 1e-5 and the
    parameters to the reference's by :func:`check_params`. With ``f64``
    (``case`` has a "grads_step") the one-device gates run in float64
    at F64_RTOL / F64_ATOL and
    test_first_step_gradients_equal_the_ports_one_device joins them (in
    f32 too, within 1e-4); the parameters are then held to the
    one-device port's in float64 alone: in f32 a near-zero first
    gradient's sign is rounding, which Adam's first update (lr times
    the sign) carries into the parameters, so that neither the f32 nor
    the f64 mesh's parameters stay within check_params' bound of the f32
    reference's at every element (F64_RTOL's readings)."""
    import pytest

    @pytest.fixture(scope="module")
    def runs(tmp_path_factory):
        return run_all(tmp_path_factory.mktemp("train_mesh"), entries, case,
                       extra=extra, f64=f64)

    each = pytest.mark.parametrize("name", entries)

    @each
    def test_steps_equal_the_references_sharded_step(runs, name):
        check_steps(runs["got"][name]["steps"], runs["ref"][name]["steps"])

    @each
    def test_steps_equal_the_ports_one_device_step(runs, name):
        arch = entries[name][0]
        if f64:
            check_steps(runs["got64"][name]["steps"],
                        runs["one64"][arch]["steps"], F64_RTOL)
        else:
            check_steps(runs["got"][name]["steps"],
                        runs["one_device"][arch]["steps"], 1e-5)

    @each
    def test_first_step_gradients_equal_the_ports_one_device(runs, name):
        """The first step's gradients, gathered from the ranks, leaf by
        leaf: in f32 within 1e-4 of the leaf's largest one-device
        gradient, in f64 within F64_RTOL of it."""
        arch = entries[name][0]
        flips = check_grads(runs["got"][name]["grads"],
                            runs["one_device"][arch]["grads"])
        check_grads(runs["got64"][name]["grads"],
                    runs["one64"][arch]["grads"], F64_RTOL)
        # for the record (pytest -s): where the f32 signs differ
        for path, i, got, want, top in flips:
            print(name, path, i, f"f32 mesh {got:.3e} one device "
                  f"{want:.3e} (leaf's largest {top:.3e})")

    @each
    def test_parameters_after_three_steps(runs, name):
        arch = entries[name][0]
        if f64:
            check_close(runs["got64"][name]["final"],
                        runs["one64"][arch]["final"], F64_ATOL)
        else:
            check_params(runs["got"][name]["final"],
                         runs["ref"][name]["final"],
                         runs["one_device"][arch]["final"])

    @each
    def test_collectives_equal_the_dry_runs(runs, name):
        arch, mesh = entries[name]
        scalars = check_collectives(
            runs["got"][name]["stats"], dict(case, arch=arch,
                                             mesh=list(mesh)))
        want = {("all-reduce", "world"): 2}
        if mesh[0] > 1:
            want[("all-reduce", "fsdp")] = 1
        assert scalars == want

    tests = dict(locals(), _one_torch_thread=one_torch_thread())
    if not f64:
        del tests["test_first_step_gradients_equal_the_ports_one_device"]
    return {k: v for k, v in tests.items()
            if k in ("runs", "_one_torch_thread") or k.startswith("test_")}


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
