"""Streaming retrieval serving driver — the NDSearch engine as an
always-on service with open-loop (Poisson) query arrivals, on the port.

Where ``repro_torch.launch.search`` runs one frozen batch per call, this
driver keeps a fixed pool of query slots saturated through the
streaming scheduler (core/scheduler.py): queries arrive on a Poisson
clock, are admitted the round a slot frees up, and retire individually
with per-query latency — the paper's query-level scheduling (§V).
Reports slot occupancy, p50/p95/p99 latency (rounds + wall), sustained
QPS and the host-sync model, with the reference CLI's JSON keys plus
``device`` and ``host_syncs``. With ``--topr R`` the index is built
spatially partitioned (core/router.py) and each query runs as R routed
legs fused at retire time; ``--ring``/``--overload`` bound the flat
path's device admission queue; ``--device-pages P`` keeps only P vector
pages per shard on the device (the tiered page store,
core/pagestore.py), the rest in host memory, fetched at chunk
boundaries on demand and by speculative prefetch (``--no-prefetch``,
``--prefetch-page-w``). ``--delta-cap C`` serves a live index
(core/live.py): Poisson inserts (``--insert-rate``) into a delta segment
of C rows and deletes (``--delete-rate``) as tombstones run against the
query stream, a full delta (or ``--refresh-every`` mutations) reindexes
and swaps a new epoch in, result ids are external ids and recall is
measured against the final live set.

  PYTHONPATH=src python -m repro_torch.launch.serve_stream --dataset tiny \\
      --queries 128 --shards 4 --slots 8 --arrival-rate 2 --spec 4 \\
      --spec-dynamic
  PYTHONPATH=src python -m repro_torch.launch.serve_stream --dataset tiny \\
      --topr 2 --down-shards 1
  PYTHONPATH=src python -m repro_torch.launch.serve_stream --device cpu \\
      --dataset tiny --n 512
  PYTHONPATH=src python -m repro_torch.launch.serve_stream --device cpu \\
      --dataset tiny --n 512 --device-pages 4
  PYTHONPATH=src python -m repro_torch.launch.serve_stream --device cpu \\
      --dataset tiny --n 512 --insert-rate 0.35 --delete-rate 0.1 \\
      --delta-cap 16
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.core.engine import EngineParams, pack_for_engine
from repro_torch.core.graph import brute_force_topk, recall_at_k
from repro_torch.core.live import build_live_index, mutation_schedule
from repro_torch.core.metrics import stream_summary
from repro_torch.core.pagestore import PageStore
from repro_torch.core.ref_search import SearchParams
from repro_torch.core.router import build_live_router, build_routed_index
from repro_torch.core.scheduler import (poisson_arrivals,
                                        routed_stream_search, stream_search)
from repro_torch.data.vectors import PAPER_DATASETS, VectorDataset
from repro_torch.ft.inject import parse_fault_args
from repro_torch.launch.search import build_index
from repro_torch.utils import resolve_device


class StreamingRetriever:
    """Retrieval-as-a-service facade for the two-stage RAG pipeline.

    Owns a packed index (on ``device``) + engine params; each
    :meth:`retrieve` call is a streaming client session — queries flow
    through the slot pool with retire/refill instead of one frozen batch
    (``repro_torch.launch.serve --rag --stream-retrieval``)."""

    def __init__(self, db: np.ndarray, packed, *, L=16, W=1, k=4,
                 num_slots=4, spec=0, dynamic_spec=False,
                 kernel_mode="auto", coalesce_qb=8, round_chunk=8,
                 injit_admit=None, device="cuda"):
        self.db = db
        self.device = resolve_device(device)
        self.consts, self.geom, self.entry = pack_for_engine(
            packed, device=self.device)
        self.params = EngineParams.lossless(
            SearchParams(L=L, W=W, k=k), num_slots, packed.max_degree,
            spec_width=spec, kernel_mode=kernel_mode,
            coalesce_qb=coalesce_qb)
        self.num_slots = num_slots
        self.dynamic_spec = dynamic_spec
        self.round_chunk = round_chunk
        self.injit_admit = injit_admit

    def retrieve(self, queries: np.ndarray, arrivals=None):
        """(N, d) queries -> (vecs (N, k, d), ids, dists, StreamStats)."""
        ids, dists, stats = stream_search(
            self.consts, self.geom, self.params, self.entry, queries,
            num_slots=self.num_slots, arrivals=arrivals,
            dynamic_spec=self.dynamic_spec, round_chunk=self.round_chunk,
            injit_admit=self.injit_admit, device=self.device)
        vecs = self.db[np.clip(ids, 0, self.db.shape[0] - 1)]
        return vecs, ids, dists, stats


def build_live_session(db, *, shards, page_size, r, insert_rate,
                       delete_rate, delta_cap, refresh_every, arrival_rate,
                       nq, arrivals_seed, pref_width=0, seed=0,
                       with_router=False, kernel_mode="auto",
                       device="cuda"):
    """A :class:`repro_torch.core.live.LiveIndex` sized for a streaming
    session: the mutation schedule spans the session's arrival horizon
    (the Poisson draw ``stream_report`` makes), the capacity is n0 plus
    the scheduled inserts, and, when routing, the striped layout gets a
    :func:`repro_torch.core.router.build_live_router` sketch (on
    ``device``) that the index refits at every epoch swap."""
    arr = poisson_arrivals(arrival_rate, nq, arrivals_seed)
    horizon = max(int(arr.max()) + 1, 2 * nq)
    sched = mutation_schedule(insert_rate, delete_rate, horizon,
                              db.shape[1], seed=seed + 5, ref=db)
    live = build_live_index(db, shards=shards, page_size=page_size, r=r,
                            delta_cap=delta_cap, pref_width=pref_width,
                            seed=seed, refresh_every=refresh_every,
                            schedule=sched)
    if with_router:
        live.router = build_live_router(live.ep, seed=seed,
                                        kernel_mode=kernel_mode,
                                        device=device)
    return live


def stream_report(consts, geom, params, entry, db, queries, *, slots,
                  arrival_rate, seed, dynamic_spec=False, refill=True,
                  round_chunk=8, injit_admit=None, routed=None, topr=0,
                  leg_L=None, spec_page_w=0.0, ring_capacity=0,
                  overload="block", down_shards=None, device_pages=0,
                  prefetch=True, prefetch_page_w=1.0, live=None,
                  device="cuda") -> dict:
    """Run one streaming session and build the serving report shared by
    the ``search --stream`` and ``serve_stream`` CLIs: Poisson arrivals
    -> scheduler -> recall vs brute force + ``stream_summary`` metrics.

    With ``routed`` (a :class:`repro_torch.core.router.RoutedIndex`) and
    ``topr`` > 0 the queries take the two-tier path: the coarse router
    picks each query's top-R shards, one leg runs per target shard and
    the legs' top-k fuse at retire time; ``down_shards`` drops the legs
    of known-down shards (degraded fusion). ``ring_capacity`` /
    ``overload`` bound the flat path's device admission queue.
    Deadlines, fault plans and the corruption guard ride on ``params``
    (``deadline_rounds``, ``faults``, ``guard_nonfinite``).

    ``device_pages`` > 0 turns on the tiered page store
    (core/pagestore.py): that many vector pages per shard stay on the
    device, the rest live in host memory and are fetched at chunk
    boundaries on demand, plus speculative prefetch when ``prefetch`` is
    set (``prefetch_page_w`` weighs the stored prefetch lists in the
    prediction score); build its ``consts`` with
    ``pack_for_engine(..., host_pages=True)`` so that the full store
    stays off the device.

    A ``live`` :class:`repro_torch.core.live.LiveIndex` turns on the
    live-index path: its mutation schedule runs against the query
    stream, result ids are external ids, and recall is measured against
    the *final* live dataset; with ``topr`` > 0 it serves the one-leg
    fan-out over the striped layout through the index's own router."""
    arrivals = poisson_arrivals(arrival_rate, queries.shape[0], seed)
    pagestore = None
    if device_pages > 0:
        if routed is not None and topr > 0:
            raise SystemExit("--device-pages needs the flat path "
                             "(tiered store is not routed-aware)")
        pagestore = PageStore(consts, geom, device_pages,
                              w_select=params.search.W, prefetch=prefetch,
                              page_w=prefetch_page_w)
        params = dataclasses.replace(params,
                                     store_pages=pagestore.num_pages)
    if live is not None and topr > 0:
        ids, _, st = routed_stream_search(
            consts, geom, params, entry, queries, router=live.router,
            topr=topr, num_slots=slots, arrivals=arrivals,
            dynamic_spec=dynamic_spec, round_chunk=round_chunk,
            injit_admit=injit_admit, spec_page_w=spec_page_w,
            down_shards=down_shards, live=live, device=device)
    elif routed is not None and topr > 0:
        ids, _, st = routed_stream_search(
            consts, geom, params, entry, queries, router=routed.router,
            topr=topr, num_slots=slots, arrivals=arrivals,
            dynamic_spec=dynamic_spec, round_chunk=round_chunk,
            injit_admit=injit_admit, shard_entries=routed.shard_entries,
            leg_L=leg_L, spec_page_w=spec_page_w,
            down_shards=down_shards, device=device)
    else:
        ids, _, st = stream_search(
            consts, geom, params, entry, queries, num_slots=slots,
            arrivals=arrivals, dynamic_spec=dynamic_spec, refill=refill,
            round_chunk=round_chunk, injit_admit=injit_admit,
            spec_page_w=spec_page_w, ring_capacity=ring_capacity,
            overload=overload, pagestore=pagestore, live=live,
            device=device)
    k = params.search.k
    if live is not None:
        vecs, exts = live.final_dataset()
        true_ids = exts[brute_force_topk(vecs, queries, k)[0]]
    else:
        true_ids, _ = brute_force_topk(db, queries, k)
    return {
        "shards": geom.num_shards, "slots_per_shard": slots,
        "arrival_rate": arrival_rate, "refill": refill,
        "spec": params.spec_width, "spec_dynamic": dynamic_spec,
        "round_chunk": round_chunk, "topr": topr,
        "deadline_rounds": params.deadline_rounds,
        "ring": ring_capacity, "overload": overload,
        "device_pages": pagestore.P_dev if pagestore else 0,
        "live": live is not None, "delta_cap": params.delta_cap,
        "inserts": live.inserts if live is not None else 0,
        "nan_guard": params.guard_nonfinite,
        "faults": params.faults is not None,
        "down_shards": sorted(int(s) for s in (down_shards or [])),
        # injit_admit arrives via stream_summary: the scheduler's
        # *resolved* admission path
        "recall@k": round(float(recall_at_k(ids, true_ids)), 4),
        **stream_summary(st),
    }


def add_fault_args(ap, prefix: str = "") -> None:
    """The fault-injection flags of the serving CLIs (``prefix`` leads
    each help text, as ``search --stream``'s do)."""
    ap.add_argument("--kill-shard", action="append", default=[],
                    metavar="S:R",
                    help=prefix + "fault injection: shard S dies at round "
                         "R (repeatable; needs --deadline-rounds)")
    ap.add_argument("--delay-shard", action="append", default=[],
                    metavar="S:R:D",
                    help=prefix + "fault injection: shard S stalls D "
                         "rounds from round R (repeatable)")
    ap.add_argument("--corrupt-pages", type=float, default=0.0,
                    help=prefix + "fault injection: corrupt this fraction "
                         "of page reads (deterministic per page)")
    ap.add_argument("--corrupt-mode", default="nan", choices=["nan", "neg"],
                    help="what a corrupt read returns: NaN or a huge "
                         "negative distance")
    ap.add_argument("--nan-guard", action="store_true",
                    help=prefix + "quarantine non-finite/garbage "
                         "distances to BIG_DIST before the merge (and "
                         "count them)")


def add_routing_args(ap, prefix: str = "") -> None:
    """The routing and overload flags of the serving CLIs (``prefix``
    leads each help text, as ``search --stream``'s do)."""
    ap.add_argument("--topr", type=int, default=0,
                    help=prefix + "two-tier routing: coarse-route each "
                         "query to its top-R shards and run one leg per "
                         "shard (0 = all-shard fan-out; builds a "
                         "spatially partitioned index instead of the "
                         "striped one)")
    ap.add_argument("--leg-L", type=int, default=0,
                    help=prefix + "routed: per-leg candidate-list length "
                         "(0 = auto from per-shard graph depth: "
                         "k + 2*log_deg(n/S))")
    ap.add_argument("--ring", type=int, default=0,
                    help=prefix + "bounded device admission ring: at most "
                         "this many pending queries staged on the device "
                         "(0 = stage the whole stream)")
    ap.add_argument("--overload", default="block", choices=["block", "shed"],
                    help=prefix + "full-ring policy: block (arrivals wait "
                         "on the host) or shed (reject arrivals while the "
                         "ring is full)")
    ap.add_argument("--down-shards", default="",
                    help=prefix + "routed: comma-separated shard ids known "
                         "down; their legs are dropped and queries fuse "
                         "degraded (needs --topr)")


def add_tiered_args(ap, prefix: str = "") -> None:
    """The tiered page store's flags of the serving CLIs (``prefix``
    leads each help text, as ``search --stream``'s do)."""
    ap.add_argument("--device-pages", type=int, default=0,
                    help=prefix + "tiered page store: device-resident "
                         "vector pages per shard; the rest live cold in "
                         "host memory and fetch at chunk boundaries "
                         "(0 = fully device-resident, untiered)")
    ap.add_argument("--prefetch", action=argparse.BooleanOptionalAction,
                    default=True,
                    help=prefix + "tiered: double-buffered speculative "
                         "prefetch at chunk boundaries (--no-prefetch = "
                         "demand-only fetching)")
    ap.add_argument("--prefetch-page-w", type=float, default=1.0,
                    help=prefix + "tiered: weight of the stored "
                         "speculative prefetch lists in the prediction "
                         "score (adjacency neighbors weigh 1)")


def add_live_args(ap, prefix: str = "") -> None:
    """The live index's flags of the serving CLIs (``prefix`` leads each
    help text, as ``search --stream``'s do)."""
    ap.add_argument("--insert-rate", type=float, default=0.0,
                    help=prefix + "live index: mean Poisson vector inserts "
                         "per engine round (needs --delta-cap)")
    ap.add_argument("--delete-rate", type=float, default=0.0,
                    help=prefix + "live index: mean Poisson tombstone "
                         "deletes per engine round (needs --delta-cap)")
    ap.add_argument("--delta-cap", type=int, default=0,
                    help=prefix + "live index: append-only delta-segment "
                         "rows; a full delta forces a background reindex "
                         "(0 = frozen index)")
    ap.add_argument("--refresh-every", type=int, default=0,
                    help=prefix + "live index: reindex + epoch swap after "
                         "this many mutations (0 = only when the delta "
                         "fills)")


def live_session(db0, args, nq: int, dev):
    """The live index of the flags (None without ``--delta-cap``), after
    the reference CLIs' refusal of shard-local routed legs."""
    if args.delta_cap <= 0:
        return None
    if 0 < args.topr < args.shards:
        raise SystemExit("live index needs --topr >= --shards "
                         "(shard-local legs cannot mask the delta)")
    return build_live_session(
        db0, shards=args.shards, page_size=args.page_size, r=args.degree,
        insert_rate=args.insert_rate, delete_rate=args.delete_rate,
        delta_cap=args.delta_cap, refresh_every=args.refresh_every,
        arrival_rate=args.arrival_rate, nq=nq, arrivals_seed=args.seed + 2,
        pref_width=args.spec, seed=args.seed, with_router=args.topr > 0,
        kernel_mode=args.kernel_mode, device=dev)


def tiered_report_args(args) -> dict:
    """stream_report's tiered-store keywords from the flags."""
    return dict(device_pages=args.device_pages, prefetch=args.prefetch,
                prefetch_page_w=args.prefetch_page_w)


def routed_index(db0, args, dev):
    """``build_routed_index`` over the largest prefix of ``db0`` that
    fills whole pages on every shard, with the degree raised to the
    shard count (the medoid stitch needs it), as the reference CLIs
    build it."""
    grid = args.shards * args.page_size
    return build_routed_index(
        db0[:db0.shape[0] // grid * grid], shards=args.shards,
        page_size=args.page_size, r=max(args.degree, args.shards),
        pref_width=args.spec, seed=args.seed,
        kernel_mode=args.kernel_mode, device=dev)


def routing_report_args(args, routed) -> dict:
    """stream_report's routing and overload keywords from the flags."""
    return dict(routed=routed, topr=args.topr, leg_L=args.leg_L or None,
                ring_capacity=args.ring, overload=args.overload,
                down_shards=[int(s) for s in args.down_shards.split(",")]
                if args.down_shards else None)


def fault_params(args) -> dict:
    """EngineParams fields of the parsed fault flags: the plan (None when
    every knob is at rest; the corruption hash salted by ``--seed``) and
    the guard."""
    return {"faults": parse_fault_args(
                args.shards, kill=args.kill_shard, delay=args.delay_shard,
                corrupt_rate=args.corrupt_pages,
                corrupt_mode=args.corrupt_mode, seed=args.seed),
            "guard_nonfinite": args.nan_guard}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="tiny",
                    choices=sorted(PAPER_DATASETS) + ["tiny"])
    ap.add_argument("--n", type=int, default=0)
    ap.add_argument("--queries", type=int, default=128)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--degree", type=int, default=16)
    ap.add_argument("--L", type=int, default=32)
    ap.add_argument("--W", type=int, default=1)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--slots", type=int, default=8,
                    help="query slots per shard")
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="mean Poisson arrivals per engine round "
                         "(0 = all at round 0)")
    ap.add_argument("--spec", type=int, default=0,
                    help="max speculative prefetch width")
    ap.add_argument("--spec-dynamic", action="store_true",
                    help="per-query hit-rate speculation controller")
    ap.add_argument("--spec-page-w", type=float, default=0.0,
                    help="page-efficiency weight for the dynamic "
                         "controller (0 = hit-rate only)")
    ap.add_argument("--no-refill", action="store_true",
                    help="frozen-batch discipline (baseline): admit "
                         "only into an all-free pool")
    ap.add_argument("--round-chunk", type=int, default=8,
                    help="engine rounds per dispatch (engine_run_chunk); "
                         "the schedule stays exactly per-round")
    ap.add_argument("--injit-admit", default="auto",
                    choices=["auto", "on", "off"],
                    help="seat arrived queries from a device-side "
                         "pending queue inside the round chunk (auto = "
                         "on whenever refill admission is active)")
    ap.add_argument("--deadline-rounds", type=int, default=0,
                    help="force-retire a query after this many serving "
                         "rounds in a slot, flagging it truncated "
                         "(0 = no deadline)")
    add_routing_args(ap)
    add_tiered_args(ap)
    add_live_args(ap)
    add_fault_args(ap)
    ap.add_argument("--kernel-mode", default="auto",
                    choices=["auto", "cuda", "ref", "torch"],
                    help="hot-path backend: the CUDA kernels (auto on a "
                         "card), their plain versions (ref), or inline "
                         "torch ops")
    ap.add_argument("--coalesce-qb", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device for the search (cuda or cpu)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.dataset == "tiny":
        ds = VectorDataset("tiny", n=args.n or 4096, dim=48, clusters=32)
    else:
        ds = PAPER_DATASETS[args.dataset]
        if args.n:
            ds = dataclasses.replace(ds, n=args.n)
    db0 = ds.materialize()
    queries = ds.queries(args.queries, seed=args.seed + 1)
    routed = None
    live = live_session(db0, args, queries.shape[0], dev)
    if live is not None:
        db, packed = db0, live.ep.packed
    elif args.topr > 0:
        routed = routed_index(db0, args, dev)
        db, packed = routed.db, routed.packed
    else:
        db, packed = build_index(
            db0, shards=args.shards, page_size=args.page_size,
            r=args.degree, pref_width=args.spec, seed=args.seed)
    # a tiered session keeps the vector pages in host memory: only the
    # store's frames go to the device
    consts, geom, entry = pack_for_engine(
        packed, device=dev, host_pages=args.device_pages > 0)
    params = EngineParams.lossless(
        SearchParams(L=args.L, W=args.W, k=args.k), args.slots,
        packed.max_degree, spec_width=args.spec,
        kernel_mode=args.kernel_mode, coalesce_qb=args.coalesce_qb,
        deadline_rounds=args.deadline_rounds, delta_cap=args.delta_cap,
        **fault_params(args))

    res = {
        "dataset": ds.name, "n": int(db.shape[0]),
        "kernel_mode": args.kernel_mode,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        **stream_report(consts, geom, params, entry, db, queries,
                        slots=args.slots, arrival_rate=args.arrival_rate,
                        seed=args.seed + 2,
                        dynamic_spec=args.spec_dynamic,
                        refill=not args.no_refill,
                        round_chunk=args.round_chunk,
                        injit_admit={"auto": None, "on": True,
                                     "off": False}[args.injit_admit],
                        spec_page_w=args.spec_page_w,
                        **routing_report_args(args, routed),
                        **tiered_report_args(args), live=live,
                        device=dev),
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
