"""Rank body of tests/test_torch_mesh.py: one ``gloo`` rank of an engine
mesh on the CPU, and the sessions each case runs.

    python tests/torch_mesh_ranks.py CASE RANK WORLD DIR

``DIR/index.pkl`` holds the parent's build (the packed integer index,
its queries and arrivals, the routed build). The rank joins the group
through ``DIR/rendezvous``, runs CASE's sessions on the mesh and writes
what they return to ``DIR/rank<RANK>.pkl``. The parent runs the same
:func:`run_case` with no mesh (the sim driver) for the expected values.
Imports torch, numpy and the port only.
"""
from __future__ import annotations

import datetime
import pickle
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.engine import (EngineParams, pack_for_engine,
                                     search_distributed, search_sim,
                                     shard_consts)
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.scheduler import routed_stream_search, stream_search
from repro_torch.ft.inject import fault_plan

CPU = dict(device="cpu")
SP = SearchParams(L=16, W=2, k=10)
SLOTS = 3
# (spec_width, kernel_mode) of tests/multishard_check.py's search legs
SEARCH = ((0, "torch"), (4, "torch"), (4, "ref"))
# (dynamic, round_chunk, injit_admit) of its streaming legs: the default
# path (in-device admission at chunk 1), chunk 1 against 4 with host
# admission, and in-device against host admission at chunk 4
STREAMS = ((False, 1, None), (True, 1, None), (False, 1, False),
           (False, 4, False), (True, 1, False), (True, 4, False),
           (False, 4, True), (True, 4, True))
# what each world runs: world 8 the four legs and the routed session,
# worlds 4 and 2 (2 and 4 shards per rank) a search and the in-device
# admission stream, world 4 also the fault session
CASES = {
    "w8": dict(search=SEARCH, streams=STREAMS, routed=True),
    "w4": dict(search=((4, "torch"),), streams=((False, 4, True),),
               faults=True),
    "w2": dict(search=((4, "torch"),), streams=((False, 4, True),)),
}
# the fault session: shard 3 killed at round 6 (rank 1's second row at
# world 4), shard 6 delayed, NaN page corruption under the guard
DEADLINE = 24


def fault_params(geom):
    spec = fault_plan(geom.num_shards).kill(3, 6).delay(6, 2, 4).corrupt(
        0.08, "nan", seed=3)
    return EngineParams.lossless(SP, SLOTS, geom.max_degree, spec_width=4,
                                 guard_nonfinite=True, faults=spec,
                                 deadline_rounds=DEADLINE)


# the session counters and traces :func:`summary` keeps; the last two
# are the port's own (the reference's sessions have neither)
SUMMARY = ("total_rounds", "occupancy_trace", "spec_trace", "pages_unique",
           "items_recv", "props_sent", "drops_b", "host_dispatches",
           "idle_rounds", "injit_admit", "legs", "items_by_shard",
           "truncated", "quarantined", "stalls", "legs_fused_hist",
           "host_syncs", "warmup_rounds")
PORT_ONLY = ("host_syncs", "warmup_rounds")


def records(st) -> dict:
    """Every QueryResult field but the wall time (dists as bits)."""
    return {r.qid: (tuple(r.ids), tuple(np.asarray(r.dists).view(np.int32)),
                    r.arrival_round, r.admit_round, r.retire_round,
                    r.service_rounds, r.n_dist, r.truncated, r.stall_rounds,
                    r.legs_fused, r.coverage)
            for r in st.results}


def summary(st, fields=SUMMARY) -> dict:
    """The session's counters and traces (no clock)."""
    return {f: getattr(st, f) for f in fields}


def _search(data, consts, mesh, spec, mode):
    _, geom, entry = data["engine"]
    qsh = data["queries"].reshape(geom.num_shards, -1,
                                  data["queries"].shape[1])
    params = EngineParams.lossless(SP, qsh.shape[1], geom.max_degree,
                                   spec_width=spec, kernel_mode=mode)
    if mesh is None:
        i, d, st = search_sim(consts, qsh, *entry, params, geom, **CPU)
    else:
        i, d, st = search_distributed(consts, qsh, *entry, params, geom,
                                      mesh, **CPU)
    return {"ids": i.numpy(), "dists": d.numpy().view(np.int32),
            **{k: (v if k == "host_syncs" else v.numpy())
               for k, v in st.items()}}


def _session(st) -> dict:
    return {"records": records(st), "summary": summary(st)}


def _rank_consts(consts, mesh):
    """A mesh rank's shards of the consts, sliced once per case."""
    return consts if mesh is None else shard_consts(consts, mesh)


def run_case(case: str, data: dict, mesh) -> dict:
    """CASE's sessions on ``mesh`` (None: the sim driver)."""
    cfg = CASES[case]
    consts, geom, entry = data["engine"]
    consts = _rank_consts(consts, mesh)
    out = {}
    for spec, mode in cfg["search"]:
        out[("search", spec, mode)] = _search(data, consts, mesh, spec, mode)
    params = EngineParams.lossless(SP, SLOTS, geom.max_degree, spec_width=4)
    for dyn, chunk, injit in cfg["streams"]:
        _, _, st = stream_search(consts, geom, params, entry,
                                 data["queries"], num_slots=SLOTS,
                                 arrivals=data["arrivals"],
                                 dynamic_spec=dyn, round_chunk=chunk,
                                 injit_admit=injit, mesh=mesh, **CPU)
        out[("stream", dyn, chunk, injit)] = _session(st)
    if cfg.get("faults"):
        _, _, st = stream_search(consts, geom, fault_params(geom), entry,
                                 data["queries"], num_slots=SLOTS,
                                 arrivals=data["arrivals"], round_chunk=4,
                                 injit_admit=True, mesh=mesh, **CPU)
        out[("faults",)] = _session(st)
    if cfg.get("routed"):
        ri = data["routed"]
        rconsts, rgeom, rentry = data["routed_engine"]
        rconsts = _rank_consts(rconsts, mesh)
        rparams = EngineParams.lossless(SP, SLOTS, rgeom.max_degree,
                                        kernel_mode="ref")
        _, _, st = routed_stream_search(
            rconsts, rgeom, rparams, rentry, data["queries"],
            router=ri.router, topr=2, num_slots=SLOTS,
            arrivals=data["arrivals"], round_chunk=4, injit_admit=True,
            shard_entries=ri.shard_entries, mesh=mesh, **CPU)
        out[("routed",)] = _session(st)
    return out


def load(path: Path) -> dict:
    """The parent's build, with the engine consts packed on the CPU."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    data["engine"] = pack_for_engine(data["packed"], **CPU)
    if data.get("routed") is not None:
        data["routed_engine"] = pack_for_engine(data["routed"].packed, **CPU)
    return data


def main(argv) -> int:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_engine_mesh
    case, rank, world, out = argv[0], int(argv[1]), int(argv[2]), \
        Path(argv[3])
    # one intra-op thread: a case's ranks share the cores with the
    # other test workers
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{out / 'rendezvous'}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        res = run_case(case, load(out / "index.pkl"),
                       make_engine_mesh(num=world))
        with open(out / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
