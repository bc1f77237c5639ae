"""Tensor parallelism for the SSD family against the reference's sharded
step: reduced mamba2-780m at (data, model) = (1, 2) and (2, 2); batch 4
x 32, loss chunk 32, remat full, 3 steps, the reference's
``PRNGKey(0)`` weights. The gates of ``torch_train_mesh_ranks.gate_tests``
with its f64 one-device gates: steps against the reference's sharded
step (f32), steps, first-step gradients and parameters against the
port's one-device step (f64; the gradients in f32 too), and the
collectives against ``launch/dryrun.py``'s, kind by kind: where d_inner
splits, the SSD's input and output (Megatron's f and g), its gated
norm's statistic (summed both ways) and the B and C leaves' gradient
sums over "model". Also the gated norm's collective alone at world 2.
zamba2 (the hybrid, the same SSD blocks) is
tests/test_torch_train_mesh_tp_hybrid.py's.
"""
import pickle

import torch
import torch.multiprocessing as mp

import torch_train_mesh_ranks as ranks

ENTRIES = {"mamba2_m2": ("mamba2-780m", (1, 2)),
           "mamba2_d2m2": ("mamba2-780m", (2, 2))}
CASE = dict(steps=3, batch=4, seq=32, stats_step=1, grads_step=0)

globals().update(ranks.gate_tests(ENTRIES, CASE, f64=True))


def _norm_rank(rank, world, tmp):
    """One rank of the gated norm's test: its slice of d_inner through
    the norm with ``par.norm_sum`` (both ways) and with Megatron's g
    (identity backward), the gradients of a fixed cotangent beside the
    unsharded norm's slice of them."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.mesh import init_train_group, make_train_mesh
    from repro_torch.models.layers import rmsnorm
    from repro_torch.train.parallel import STATS, MeshShard, all_reduce
    torch.set_num_threads(1)
    init_train_group("cpu", init_method=f"file://{tmp / 'rdv'}", rank=rank,
                     world=world, timeout_s=120)
    cfg = reduced(get_config("mamba2-780m"))
    par = MeshShard(cfg, make_train_mesh([1, world], device="cpu"))
    di, eps = cfg.d_inner, cfg.norm_eps
    gen = torch.Generator().manual_seed(0)
    y, cot = (torch.randn(2, 8, di, generator=gen)
              for _ in range(2))
    scale = 1 + 0.1 * torch.randn(di, generator=gen)
    cut = slice(rank * di // world, (rank + 1) * di // world)

    def grads(fn, y, scale, cot):
        y, scale = y.clone().requires_grad_(), scale.clone().requires_grad_()
        out = fn(y, scale)
        return torch.autograd.grad((out * cot).sum(), (y, scale))

    want = grads(lambda y, s: rmsnorm({"scale": s}, y, eps), y, scale, cot)
    want = [want[0][..., cut], want[1][cut]]
    res = {}
    for name, reduce in (("both", par.norm_sum),
                         ("identity", lambda x: all_reduce(x, par.mesh,
                                                           "model"))):
        STATS.reset()

        def norm(y, s):
            return rmsnorm({"scale": s}, y, eps, sum_sq=reduce, width=di)
        got = grads(norm, y[..., cut], scale[cut], cot[..., cut])
        res[name] = {"err": max(float((g - w).abs().max())
                                for g, w in zip(got, want)),
                     "calls": sum(c for *_, c in STATS.rows("step"))}
    with open(tmp / f"norm{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    torch.distributed.destroy_process_group()


def test_gated_norm_statistic_sums_both_ways(tmp_path):
    """The SSD gated norm at a cut of d_inner, world 2 over gloo: with
    ``MeshShard.norm_sum`` (an all-reduce in the forward and in the
    backward, two counted calls) each rank's gradients equal its slice
    of the unsharded norm's; with an identity backward (Megatron's g)
    they do not, since each rank's cotangent of the shared statistic is
    only its own slice's part."""
    mp.spawn(_norm_rank, args=(2, tmp_path), nprocs=2)
    for r in range(2):
        with open(tmp_path / f"norm{r}.pkl", "rb") as f:
            res = pickle.load(f)
        print(f"rank {r}: both ways {res['both']['err']:.4g}, identity "
              f"backward {res['identity']['err']:.4g}")   # for the record
        assert res["both"]["err"] < 1e-5
        assert res["both"]["calls"] == 2
        assert res["identity"]["err"] > 1e-3
