"""The port's dry run (``launch/dryrun.py``) and the kernels' shape-only
path on "meta" tensors: the analytic FLOP formulas against the
reference's for every arch x shape (exact), a 2-layer dense cell's
collective wire bytes computed by hand from the module doc's formulas
(exact), per-device operations x devices against one device's count of
the same cell (within 5%: work the rules replicate, norms and residual
adds, is counted once per model rank), each kernel's declared cost on
meta and ``cuda`` refused there, the CLI's file names and record keys,
and the engine cell on a small shard count."""
import dataclasses
import json
import os

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import list_archs
from repro_torch.kernels import KERNELS
from repro_torch.kernels.build import resolve_kernel_mode
from repro_torch.kernels.distance import kernel as dist_kernel
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.ops import attention_op
from repro_torch.kernels.topk import kernel as topk_kernel
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh_for
from repro_torch.launch.opanalysis import OpStream, summarize
from repro_torch.launch.specs import ArchPolicy, plan_train
from repro_torch.models.transformer import ModelOpts


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, so parallel test workers do not oversubscribe
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for
    512 host devices; the variable is put back at once, before any jax
    backend starts in this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


@pytest.mark.parametrize("arch", list_archs())
def test_flop_formulas_equal_reference(arch, ref_dryrun):
    for shape in SHAPES:
        assert dryrun.model_flops(arch, shape) == \
            ref_dryrun.model_flops(arch, shape)
        for train in (False, True):
            assert dryrun.attn_kernel_flops(arch, shape, train=train) == \
                ref_dryrun.attn_kernel_flops(arch, shape, train=train)


TINY = ArchConfig(name="tiny-dense", family="dense", num_layers=2,
                  d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
                  d_ff=128, vocab_size=512)


def _tiny_plan(mesh, layers=2):
    cfg = dataclasses.replace(TINY, num_layers=layers)
    pol = ArchPolicy(grad_accum=2, loss_chunk=32)
    opts = ModelOpts(loss_chunk=32, act_dtype=torch.bfloat16)
    return plan_train(cfg, mesh, batch=8, seq=32, policy=pol, opts=opts)


def test_two_layer_dense_collectives_by_hand():
    """data 2 x model 2, batch 8 x 32, grad-accum 2, bf16 parameters and
    activations, remat per block. Every leaf names "embed", so every
    leaf is FSDP-sharded over 2; heads, kv heads, d_ff and the vocab
    split over model 2. The terms are what the sharded step calls
    (tests/test_torch_train_mesh_counts.py counts them)."""
    mesh = make_mesh_for(4, (2, 2), ("data", "model"))
    rec = dryrun.analyze_plan(_tiny_plan(mesh))
    # one device's compute leaves (full on "embed", cut on "model")
    block = (64 + 64 * 2 * 16 + 2 * (64 * 1 * 16) + 2 * 16 * 64 + 64
             + 3 * 64 * 64)
    other = 256 * 64 + 64 * 256 + 64          # embedding, head, final norm
    numel = 2 * block + other
    G, f, m = 2, 2, 2
    # bf16; a block's leaves in its forward and its recompute, the
    # non-block leaves once (outside remat)
    gather = (2 * block * 2 + other) * 2 * (f - 1) / f
    scatter = numel * 2 * (f - 1) / f          # the backward's bf16 grads
    B_mb = 8 // f // G
    N = B_mb * 32 * 64 * 2                     # one bf16 residual stream
    ring = 2 * (m - 1) / m
    # 2 layers x (attention: forward, recompute, backward input; MLP:
    # forward, backward input: the recompute stops before its output)
    tp = 2 * (3 + 2) * N * ring
    # the embedding; the loss's one chunk: max (4 bytes per row) and the
    # pair of sums (8) in its forward and recompute, its hidden backward
    tp += N * ring + 2 * (B_mb * 32 * 12) * ring + N * ring
    got = rec["per_device"]["collectives"]["bytes_by_kind"]
    assert got == pytest.approx({"all-gather": G * gather,
                                 "reduce-scatter": G * scatter,
                                 "all-reduce": G * tp}, rel=0, abs=1e-6)
    assert rec["per_device"]["collectives"]["by_axis"]["fsdp"]["fabric"] \
        == "nvlink"
    one = make_mesh_for(1, (1, 1), ("data", "model"))
    assert dryrun.analyze_plan(_tiny_plan(one))["per_device"][
        "collective_bytes"] == 0


@pytest.mark.parametrize("arch", ["gemma2-27b", "mixtral-8x7b",
                                  "mamba2-780m"])
def test_per_device_ops_times_devices_match_one_device(arch):
    """A cell cut to 2 layers (full widths) on data 2 x model 2 and on
    one device: the per-device operations times 4 within 5% of the one
    device's."""
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    pol = ArchPolicy(grad_accum=2, loss_chunk=128)
    opts = ModelOpts(loss_chunk=128, act_dtype=torch.bfloat16)
    flops = {}
    for shape in ((1, 1), (2, 2)):
        mesh = make_mesh_for(shape[0] * shape[1], shape, ("data", "model"))
        rec = dryrun.analyze_plan(plan_train(cfg, mesh, batch=8, seq=128,
                                             policy=pol, opts=opts))
        flops[shape] = rec["per_device"]["flops"] * rec["devices"]
    assert flops[(2, 2)] == pytest.approx(flops[(1, 1)], rel=0.05)


def test_meta_kernels_report_their_cost_and_cuda_refuses_meta():
    """On meta tensors each wrapper allocates meta outputs, moves no
    launch count and reports its declared cost to the listeners; 'auto'
    resolves to 'meta'; 'cuda' on a meta tensor raises."""
    def meta(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    before = {k.name: k.launches for k in KERNELS}
    q, k = meta(2, 4, 64, 32), meta(2, 2, 64, 32)
    kw = dict(scale=0.1, causal=True, window=0, softcap=0.0, s_orig=64)
    pages = (meta(12, dtype=torch.int32), meta(12, 8, 32), meta(12, 8),
             meta(6, 16, 32), meta(6, 16))
    rows = (meta(16, 32), meta(16, 32, dtype=torch.int32))
    cand = (meta(16, 8), meta(16, 8, dtype=torch.int32),
            meta(16, 8, dtype=torch.bool), meta(16, 4),
            meta(16, 4, dtype=torch.int32), meta(16, 4, dtype=torch.bool))
    with OpStream() as st:
        out, lse = flash_kernel.flash_attention(q, k, k, return_lse=True,
                                                **kw)
        grads = flash_kernel.flash_attention_bwd(q, k, k, out, lse, out,
                                                 **kw)
        dist = dist_kernel.paged_distances(*pages)
        srt = topk_kernel.bitonic_sort(*rows)
        mrg = topk_kernel.bitonic_merge(*rows)
        uns = topk_kernel.merge_unsorted(*cand, 8)
    for t in (out, lse, *grads, dist, *srt, *mrg, *uns):
        assert t.is_meta
    assert out.shape == q.shape and lse.shape == (2, 4, 64)
    assert dist.shape == (12, 8, 16) and uns[0].shape == (16, 8)
    ker = summarize(st.records)["kernels"]
    fwd = flash_kernel.cost(q.shape, k.numel(), 4, 64, causal=True,
                            window=0, lse=True)
    bwd = flash_kernel.cost(q.shape, k.numel(), 4, 64, causal=True,
                            window=0, backward=True)
    assert (ker["flash_attention"]["flops"],
            ker["flash_attention"]["bytes"]) == fwd
    assert (ker["flash_attention_bwd"]["flops"],
            ker["flash_attention_bwd"]["bytes"]) == bwd
    assert (ker["paged_distance"]["flops"],
            ker["paged_distance"]["bytes"]) == dist_kernel.cost(12, 8, 16,
                                                                32, 6)
    assert (ker["bitonic_merge_unsorted"]["flops"],
            ker["bitonic_merge_unsorted"]["bytes"]) == \
        topk_kernel.merge_unsorted_cost(16, 8, 4, 8)
    assert ker["bitonic_sort"]["launches"] == \
        ker["bitonic_merge"]["launches"] == 1
    assert {k.name: k.launches for k in KERNELS} == before
    assert resolve_kernel_mode("auto", q) == "meta"
    assert resolve_kernel_mode("auto", torch.zeros(1)) == "ref"
    with pytest.raises(ValueError, match="cuda"):
        resolve_kernel_mode("cuda", q)
    with pytest.raises(ValueError, match="cuda"):
        attention_op(q, k, k, scale=0.1, mode="cuda")


def test_cli_writes_the_references_names_and_keys(tmp_path):
    """main(): <arch>_<shape>_<mesh>[_kernelized].json, the reference's
    record keys (its HLO-specific ones renamed: flops, hbm_bytes,
    fits_hbm, trace_s) and every record ok or the reference's skip."""
    out = str(tmp_path)
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k",
                        "--mesh", "both", "--out", out]) == 0
    assert dryrun.main(["--arch", "yi-34b", "--shape", "long_500k",
                        "--mesh", "single", "--out", out]) == 0
    assert dryrun.main(["--arch", "seamless-m4t-medium", "--shape",
                        "prefill_32k", "--attn-stub", "--out", out]) == 0
    assert sorted(os.listdir(out)) == [
        "gemma3-1b_decode_32k_multi.json",
        "gemma3-1b_decode_32k_single.json",
        "seamless-m4t-medium_prefill_32k_single_kernelized.json",
        "yi-34b_long_500k_single.json"]
    rec = json.load(open(os.path.join(out,
                                      "gemma3-1b_decode_32k_single.json")))
    assert {"arch", "shape", "mesh", "mesh_shape", "status", "kind",
            "note", "devices", "memory", "per_device", "roofline",
            "model_flops_total", "useful_flops_ratio"} <= set(rec)
    assert rec["mesh_shape"] == [16, 16] and rec["devices"] == 256
    assert set(rec["roofline"]) == {"compute_s", "memory_s",
                                    "collective_s", "dominant",
                                    "step_s_lower_bound"}
    assert {"argument_bytes", "temp_bytes", "peak_bytes_per_device",
            "fits_hbm"} <= set(rec["memory"])
    assert {"flops", "hbm_bytes", "collective_bytes",
            "collectives"} <= set(rec["per_device"])
    assert set(rec["per_device"]["collectives"]) >= {
        "bytes_by_kind", "count_by_kind", "total_bytes"}
    assert rec["links"]["model"]["fabric"] == "infiniband"
    assert "model axis" in rec["link_note"]
    skip = json.load(open(os.path.join(out, "yi-34b_long_500k_single.json")))
    assert skip["status"] == "skip" and skip["reason"] == (
        "yi-34b is pure full-attention: long_500k skipped per assignment "
        "(DESIGN.md §6)")
    ker = json.load(open(os.path.join(
        out, "seamless-m4t-medium_prefill_32k_single_kernelized.json")))
    assert ker["variant"] == "kernelized-attention"
    assert ker["analytic_attn_flops_per_dev"] == pytest.approx(
        dryrun.attn_kernel_flops("seamless-m4t-medium", "prefill_32k",
                                 train=False) / 256)


def test_engine_cell_small():
    """The engine at 4 shards: one meta round's totals over S per
    device; the four exchanges' buckets as all-to-alls, (S-1)/S of each
    rank's share on the wire; both kernels of the round reported."""
    S = 4
    rec = dryrun.run_engine_cell(mesh_kind="single", num_shards=S,
                                 pages_per_shard=8)
    assert rec["status"] == "ok", rec.get("error")
    pd = rec["per_device"]
    assert rec["mesh_shape"] == [S] and len(pd["bucket_bytes"]) == 4
    want = sum(b / S * (S - 1) / S for b in pd["bucket_bytes"])
    assert pd["collectives"]["bytes_by_kind"]["all-to-all"] == \
        pytest.approx(want)
    assert pd["collectives"]["count_by_kind"]["all-to-all"] == 4
    assert set(pd["kernels"]) == {"paged_distance", "bitonic_merge_unsorted"}
    assert pd["flops"] > pd["kernels"]["paged_distance"]["flops"] > 0
    assert rec["links"]["lun"]["fabric"] == "nvlink"


def test_engine_cli_both_meshes(tmp_path):
    assert dryrun.main(["--engine", "--mesh", "both", "--out",
                        str(tmp_path)]) == 0
    recs = [json.load(open(tmp_path / f)) for f in sorted(
        os.listdir(tmp_path))]
    assert [r["mesh_shape"] for r in recs] == [[256], [512]]
    assert all(r["status"] == "ok" and r["links"]["lun"]["fabric"]
               == "infiniband" for r in recs)
