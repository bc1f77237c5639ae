"""Layer 2: structural audit of every chunk program's op stream.

The twin of the reference's jaxpr audit. Eager torch has no jaxpr: the
program is the stream of aten ops one call dispatches. The audit builds
a tiny but real index (with the port's own Vamana and LUN-CSR code, so
the program is the production program), runs every chunk program once
uncaptured under a recording dispatch mode (``launch.opanalysis.
OpStream``), and checks the invariants the serving model rests on:

- **no sync op** on any program: no ``aten::_local_scalar_dense``
  (``.item()``, ``bool()``, ``int()`` of a tensor), no
  ``nonzero``/``masked_select``/``unique`` (data-dependent shapes), no
  copy from the device to the CPU. A capture would bake such a read or
  refuse it; it stands in for the reference's "no host callbacks", and
  it shows on the CPU too;
- **no float64**: no f64 tensor among any op's operands or outputs;
- **in place stands in for donation**: ``PageStore._install`` writes the
  frame buffers in place (their ``data_ptr`` unchanged) and allocates no
  output of a frame buffer's size;
- **op histogram snapshot**: each program's histogram is committed in
  ``audit_baseline.json`` (beside this module), keyed by torch version,
  so hot-loop growth is a reviewed diff. The comparison is strict when
  the running torch version has an entry and warns when it has none
  (torch is free to decompose differently), while the structural
  invariants stay strict.

On a card (``device="cuda"``, the default) the programs launch the
hand-written kernels, which no dispatch mode sees: the audit then counts
their launches per program instead of comparing histograms
(``paged_distance`` and the fused Gather merge once per round of every
round program). With ``device="cpu"`` they run in ``ref`` kernel mode
(the kernels' plain versions, whose ops are recorded) and the
histograms are compared.

The serving decode step joins them (``decode_step_<family>``): one
token of a reduced model of each family (dense, moe, ssm, hybrid,
encdec) against a prefilled cache, through ``launch/serve.py``'s
session uncaptured. The card captures it once per session, so the same
invariants hold for it, and on a card it launches no kernel.

Run via ``python -m repro_torch.analysis audit --device cpu|cuda``
(``--update``, on the CPU, refreshes the snapshot).
"""
from __future__ import annotations

import dataclasses
import json
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.capture import tree_leaves
from repro_torch.launch.opanalysis import OpStream
from repro_torch.utils import resolve_device

# Tiny problem: small enough to run in seconds, big enough that every
# stage (speculation, paging, admission) is structurally present.
TINY = dict(n=256, d=16, S=2, page=8, slots=2, k=4, L=8, W=1,
            spec_width=2, max_degree=6, K=4, pend=4)
# the kernels every round of a round program launches once (on a card)
ROUND_KERNELS = ("paged_distance", "bitonic_merge_unsorted")
# the serving decode step, per family: (arch, its reduced config's
# prompt length)
DECODE_ARCHS = {"dense": "gemma3-1b", "moe": "mixtral-8x7b",
                "ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
                "encdec": "seamless-m4t-medium"}
DECODE_PROMPT = 8
ROUND_PROGRAMS = ("search_sim", "engine_run_chunk", "engine_run_chunk_admit",
                  "engine_run_chunk_admit_routed",
                  "engine_run_chunk_admit_live",
                  "engine_run_chunk_admit_tiered")


def build_tiny_problem(device="cuda"):
    """A real packed index + engine params at toy scale, on ``device``
    (the kernels on a card; ``ref`` kernel mode when the caller asks for
    the CPU)."""
    from repro_torch.core.engine import (EngineParams, engine_init,
                                         pack_for_engine)
    from repro_torch.core.graph import build_vamana
    from repro_torch.core.luncsr import LUNCSR, Geometry, pack_index
    from repro_torch.core.ref_search import SearchParams
    from repro_torch.core.scheduler import _make_controller

    t = TINY
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    db = rng.integers(-8, 9, size=(t["n"], t["d"])).astype(np.float32)
    adj, medoid = build_vamana(db, r=t["max_degree"], alpha=1.2, seed=0)
    geo = Geometry(num_shards=t["S"], page_size=t["page"],
                   pages_per_block=2, dim=t["d"])
    index = LUNCSR.from_adjacency(db, adj, geo, entry=medoid, pref_width=2)
    packed = pack_index(index, max_degree=t["max_degree"])
    consts, geom, entry = pack_for_engine(packed, dev)
    params = EngineParams.lossless(
        SearchParams(L=t["L"], W=t["W"], k=t["k"]), t["slots"],
        geom.max_degree, spec_width=t["spec_width"],
        kernel_mode="ref" if dev.type == "cpu" else "cuda")
    S, Qs, d = t["S"], t["slots"], t["d"]
    queries = torch.as_tensor(
        rng.integers(-8, 9, size=(S, Qs, d)).astype(np.float32), device=dev)
    state = engine_init(consts, queries, *entry, params=params, geom=geom)
    ctrl = _make_controller(params, geom, dynamic_spec=True)
    ctrl._ensure((S, Qs))
    return dict(consts=consts, geom=geom, entry=entry, params=params,
                queries=queries, state=state, spec_state=ctrl.state(dev),
                spec_cfg=ctrl.cfg, device=dev)


def _pend_args(prob, per_shard=False):
    t, dev = TINY, prob["device"]
    d, S, cap = t["d"], t["S"], t["pend"]
    if per_shard:
        return (torch.zeros((S, cap, d), device=dev),
                torch.zeros((S, cap), dtype=torch.int32, device=dev),
                torch.zeros((S,), dtype=torch.int64, device=dev))
    return (torch.zeros((cap, d), device=dev),
            torch.zeros((cap,), dtype=torch.int32, device=dev), 0)


def _per_shard_entry(prob):
    ev, en, ei = prob["entry"]
    S, dev = TINY["S"], prob["device"]
    return (ev.expand(S, -1).contiguous(), en.expand(S).contiguous(),
            torch.full((S,), ei, dtype=torch.int32, device=dev))


def chunk_programs(prob):
    """name -> a no-argument call of that chunk program (uncaptured),
    the reference's seven under the port's names plus the port's
    ``search_sim`` chunk; and the page store the tiered and install
    programs share."""
    from repro_torch.core import engine
    from repro_torch.core.pagestore import PageStore

    p, g, K = prob["params"], prob["geom"], TINY["K"]
    consts, queries = prob["consts"], prob["queries"]
    base = (consts, prob["state"], queries, prob["spec_state"],
            prob["spec_cfg"], K)
    run = dict(params=p, geom=g, K=K, dynamic=True, capture=False)
    out = {}

    def search_chunk():
        st = engine._init_state(queries, engine._qq(queries), *prob["entry"],
                                p)
        t = torch.zeros((), dtype=torch.int32, device=prob["device"])
        return engine._search_chunk(consts, st, t, queries, p, g, K,
                                    engine._Part(TINY["S"]))
    out["search_sim"] = search_chunk
    out["engine_run_chunk"] = lambda: engine.engine_run_chunk(
        *base, True, **run)
    out["engine_run_chunk_admit"] = lambda: engine.engine_run_chunk_admit(
        *base, *_pend_args(prob), 0, *prob["entry"], **run)
    out["engine_run_chunk_admit_routed"] = \
        lambda: engine.engine_run_chunk_admit(
            *base, *_pend_args(prob, per_shard=True), 0,
            *_per_shard_entry(prob), **run)

    # live leg: the delta segment + tombstones ride in the consts as
    # fixed-shape tensors (delta_cap is the only static change)
    dcap, dev = 4, prob["device"]
    n_cap = consts["db"].shape[1] * TINY["page"] * TINY["S"]
    live_consts = {
        **consts,
        "tombs": torch.zeros((n_cap,), dtype=torch.bool, device=dev),
        "delta_vec": torch.zeros((dcap, TINY["d"]), device=dev),
        "delta_norm": torch.zeros((dcap,), device=dev),
        "delta_live": torch.zeros((dcap,), dtype=torch.bool, device=dev),
    }
    live_params = dataclasses.replace(p, delta_cap=dcap)
    out["engine_run_chunk_admit_live"] = \
        lambda: engine.engine_run_chunk_admit(
            live_consts, *base[1:], *_pend_args(prob), 0, *prob["entry"],
            **dict(run, params=live_params))
    out["engine_retire_live"] = lambda: engine.engine_retire_live(
        prob["state"], queries, *(live_consts[n] for n in
                                  engine.LIVE_CONST_KEYS), k=TINY["k"])

    # tiered leg: the consts carry the frame buffer + translation table
    NP = consts["db"].shape[1]
    ps = PageStore(consts, g, NP, w_select=1)
    tiered_params = dataclasses.replace(p, store_pages=NP)
    tiered_consts = {**consts, **ps.device_view()}
    tiered_state = engine.engine_init(tiered_consts, queries, *prob["entry"],
                                      params=tiered_params, geom=g)
    out["engine_run_chunk_admit_tiered"] = \
        lambda: engine.engine_run_chunk_admit(
            tiered_consts, tiered_state, *base[2:], *_pend_args(prob), 0,
            *prob["entry"], **dict(run, params=tiered_params))

    # the frame install (the reference's donated _scatter_frames)
    M = 4
    rows = [(s, page, page) for s in range(TINY["S"]) for page in range(2)]
    pay_db = torch.zeros((M,) + tuple(ps.frames.shape[2:]),
                         dtype=ps.frames.dtype, device=dev)
    pay_vn = torch.zeros((M,) + tuple(ps.vnf.shape[2:]),
                         dtype=ps.vnf.dtype, device=dev)
    out["pagestore_install"] = lambda: ps._install(rows, pay_db, pay_vn)
    return out, ps


def decode_programs(device) -> dict:
    """``decode_step_<family>`` -> a no-argument call of one decode step
    (uncaptured) of the family's reduced model, against a cache its
    prefill filled beforehand (outside the recorded call)."""
    from repro_torch.configs.registry import get_config, reduced
    from repro_torch.launch.serve import make_step_fns
    from repro_torch.models import transformer as T
    from repro_torch.models.frontend import frontend_shape

    dev = resolve_device(device)
    out = {}
    for fam, arch in DECODE_ARCHS.items():
        cfg = reduced(get_config(arch))
        gen = torch.Generator(device=dev).manual_seed(0)
        params = T.init_params(cfg, gen)
        B, Sp = 2, DECODE_PROMPT
        toks = torch.randint(0, cfg.vocab_size, (B, Sp + 1), generator=gen,
                             device=dev)
        shape = frontend_shape(cfg, B, Sp)
        fe = None if shape is None else torch.randn(shape, generator=gen,
                                                    device=dev)
        fns = make_step_fns(cfg, T.ModelOpts(), capture=False)
        cache = fns.cache(B, Sp + 1, Sp, dev)
        _, cache = fns.prefill(params, toks[:, :Sp], cache, fe)
        out[f"decode_step_{fam}"] = (
            lambda fns=fns, params=params, cache=cache, tok=toks[:, Sp:]:
            fns.decode(params, cache, tok))
    return out


def audit_program(records) -> dict:
    """Histogram + invariant scan of one program's op stream."""
    ops = Counter(r.name for r in records
                  if not r.name.startswith("kernel::"))
    launches = Counter(r.name[len("kernel::"):] for r in records
                       if r.name.startswith("kernel::"))
    return {"ops": dict(sorted(ops.items())),
            "total": sum(ops.values()),
            "syncs": [r.name for r in records if r.syncs],
            "f64": sorted({r.name for r in records if r.f64}),
            "launches": dict(sorted(launches.items()))}


def collect_report(device="cuda", prob=None) -> dict:
    """Full audit report over every chunk program."""
    prob = prob or build_tiny_problem(device)
    programs, ps = chunk_programs(prob)
    programs.update(decode_programs(prob["device"]))
    report = {}
    install = {}
    for name, call in programs.items():
        keep = name == "pagestore_install"
        ptrs = (ps.frames.data_ptr(), ps.vnf.data_ptr())
        with OpStream(keep_outputs=keep) as stream:
            out = call()
        report[name] = audit_program(stream.records)
        report[name]["out_dtypes"] = sorted(
            {str(leaf.dtype) for leaf in tree_leaves(
                () if out is None else out)})
        if keep:
            frame_bytes = min(ps.frames.numel() * ps.frames.element_size(),
                              ps.vnf.numel() * ps.vnf.element_size())
            install = {
                "frames_in_place": ptrs == (ps.frames.data_ptr(),
                                            ps.vnf.data_ptr()),
                "frame_sized_outputs": sum(
                    1 for r in stream.records for ptr, nb in r.outputs
                    if nb >= frame_bytes and ptr not in ptrs)}
    return {"torch_version": torch.__version__, "device": str(prob["device"]),
            "problem": dict(TINY), "programs": report,
            "invariants": install}


def baseline_payload(report) -> dict:
    """The committed subset: each program's op histogram."""
    return {name: {"total": s["total"], "ops": s["ops"]}
            for name, s in report["programs"].items()}


def check_report(report, out) -> bool:
    """The structural invariants (both devices); prints each failure."""
    ok = True
    for name, s in report["programs"].items():
        if s["syncs"]:
            ok = False
            print(f"FAIL {name}: sync ops on the chunk program: "
                  f"{sorted(set(s['syncs']))}", file=out)
        if s["f64"] or "torch.float64" in s["out_dtypes"]:
            ok = False
            print(f"FAIL {name}: float64 in the program: {s['f64'][:5]}",
                  file=out)
    inv = report["invariants"]
    if not inv.get("frames_in_place") or inv.get("frame_sized_outputs"):
        ok = False
        print(f"FAIL pagestore_install: the frame buffers were not written "
              f"in place: {inv}", file=out)
    if report["device"].startswith("cuda"):
        for name in ROUND_PROGRAMS:
            got = report["programs"][name]["launches"]
            want = {k: TINY["K"] for k in ROUND_KERNELS}
            if {k: got.get(k, 0) for k in ROUND_KERNELS} != want or \
                    set(got) - set(ROUND_KERNELS):
                ok = False
                print(f"FAIL {name}: launches {got}, expected {want} "
                      f"({TINY['K']} rounds)", file=out)
        for fam in DECODE_ARCHS:
            got = report["programs"][f"decode_step_{fam}"]["launches"]
            if got:
                ok = False
                print(f"FAIL decode_step_{fam}: launches {got}, expected "
                      f"none (decode attends on the plain path)", file=out)
    return ok


def compare_baseline(report, base: dict, out) -> bool:
    """Histograms against the committed snapshot: strict for a torch
    version the snapshot has, a warning for one it has not."""
    versions = base.get("torch", {})
    ver = report["torch_version"]
    strict = ver in versions
    if not versions:
        print("FAIL: the baseline holds no snapshot", file=out)
        return False
    ref = versions[ver] if strict else versions[sorted(versions)[-1]]
    cur = baseline_payload(report)
    ok = True
    for name in sorted(set(ref) | set(cur)):
        b, c = ref.get(name), cur.get(name)
        if b is None or c is None:
            ok = False
            print(f"FAIL: program set changed: {name} "
                  f"{'added' if b is None else 'removed'}", file=out)
            continue
        if b["ops"] != c["ops"]:
            drift = {k: (b["ops"].get(k, 0), c["ops"].get(k, 0))
                     for k in sorted(set(b["ops"]) | set(c["ops"]))
                     if b["ops"].get(k, 0) != c["ops"].get(k, 0)}
            msg = (f"{name}: op counts drifted from baseline (total "
                   f"{b['total']} -> {c['total']}): {drift}")
            if strict:
                ok = False
                print(f"FAIL {msg}", file=out)
            else:
                print(f"WARN {msg} [torch {ver} has no snapshot, count "
                      f"drift downgraded to a warning]", file=out)
    return ok


def run_audit(baseline_path, update=False, device="cuda", out=None) -> int:
    """CLI body: returns the process exit code."""
    import sys
    out = out or sys.stdout
    report = collect_report(device)
    ok = check_report(report, out)
    path = Path(baseline_path)
    on_card = report["device"].startswith("cuda")
    if update:
        if not ok or on_card:
            print("refusing to write a baseline from a "
                  + ("failing audit" if not ok else "card run (its "
                     "histograms hold kernel launches, not ops)"), file=out)
            return 1
        base = json.loads(path.read_text()) if path.exists() else {}
        base.setdefault("torch", {})[report["torch_version"]] = \
            baseline_payload(report)
        base["problem"] = report["problem"]
        path.write_text(json.dumps(base, indent=1, sort_keys=True) + "\n")
        print(f"baseline written: {path}", file=out)
        return 0
    if not on_card:
        if not path.exists():
            ok = False
            print(f"FAIL: baseline {path} missing (run `python -m "
                  f"repro_torch.analysis audit --device cpu --update`)",
                  file=out)
        else:
            ok = compare_baseline(report, json.loads(path.read_text()),
                                  out) and ok
    if ok:
        print(f"OK: op audit passed ({len(report['programs'])} programs, "
              f"{report['device']})", file=out)
    return 0 if ok else 1
