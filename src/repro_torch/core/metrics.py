"""Search-quality, locality and serving metrics (host-side numpy).

The port's own copy of the reference package's ``core/metrics.py``;
``stream_summary`` also reports ``host_syncs`` and ``warmup_rounds``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.graph import brute_force_topk, recall_at_k  # re-export
from repro_torch.core.reorder import bandwidth_beta               # re-export

__all__ = [
    "brute_force_topk", "recall_at_k", "bandwidth_beta",
    "page_access_ratio", "filter_ratio_bytes", "qps",
    "latency_percentiles", "slot_occupancy", "stream_summary",
]


def page_access_ratio(page_accesses: np.ndarray, n_dist: np.ndarray) -> float:
    """Paper Fig. 6/16 metric: #page accesses / length of the search trace."""
    n = np.maximum(np.asarray(n_dist, dtype=np.float64), 1.0)
    return float((np.asarray(page_accesses, np.float64) / n).mean())


def filter_ratio_bytes(d: int, R: int, dtype_bytes: int = 4,
                       id_bytes: int = 4, dist_bytes: int = 4) -> float:
    """Bytes(gather R vectors) / Bytes(NDSearch filtered exchange)."""
    gather = R * d * dtype_bytes
    nd = d * dtype_bytes + R * (id_bytes + dist_bytes)
    return gather / nd


def qps(num_queries: int, seconds: float) -> float:
    return num_queries / max(seconds, 1e-12)


# ---------------------------------------------------------------------------
# Streaming-scheduler metrics (core/scheduler.py, bench_serving)
# ---------------------------------------------------------------------------
def latency_percentiles(latencies) -> dict:
    """p50/p95/p99/mean of a latency sample (any unit).

    An empty sample (a run that retired zero queries) returns an all-
    zero summary instead of letting ``np.percentile`` raise."""
    lat = np.asarray(latencies, np.float64)
    if lat.size == 0:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "mean": 0.0}
    return {
        "p50": float(np.percentile(lat, 50)),
        "p95": float(np.percentile(lat, 95)),
        "p99": float(np.percentile(lat, 99)),
        "mean": float(lat.mean()),
    }


def slot_occupancy(live_counts, num_slots: int,
                   total_rounds: int | None = None) -> float:
    """Mean fraction of the slot pool holding a live query per round.

    ``live_counts`` has one entry per *busy* round (rounds the engine
    actually stepped); pass ``total_rounds`` to spread the same live
    work over the full serving clock — busy plus idle rounds — so an
    empty pool waiting for arrivals reads as occupancy 0, not as time
    that never happened."""
    live = np.asarray(live_counts, np.float64)
    rounds = live.size if total_rounds is None else total_rounds
    if rounds <= 0:
        return 0.0
    return float(live.sum() / (rounds * max(num_slots, 1)))


def stream_summary(stats) -> dict:
    """Aggregate a scheduler StreamStats into the serving report:
    occupancy, per-query latency percentiles (rounds + wall), round-
    normalized throughput, sustained wall QPS and the host-sync model
    (engine_run_chunk dispatches, the device-to-host reads the host
    blocked on, one-time warmup seconds — ``wall_s`` and per-query wall
    latency exclude the warmup, which is reported separately). Clock
    accounting: ``total_rounds`` counts engine (busy) rounds,
    ``idle_rounds`` the empty-pool gaps the scheduler skipped over;
    ``occupancy`` and ``queries_per_round`` are normalized over the
    *full* serving clock (busy + idle) so sparse arrivals don't
    overstate throughput. Safe on a run that retired
    zero queries: every percentile block is zeroed rather than
    crashing on an empty array.

    tests/test_torch_scheduler.py asserts every scalar StreamStats field
    surfaces here — extend this dict when adding a counter."""
    res = stats.results
    n = len(res)
    dispatches = getattr(stats, "host_dispatches", 0)
    idle = getattr(stats, "idle_rounds", 0)
    clock = stats.total_rounds + idle
    return {
        "queries": n,
        "total_rounds": stats.total_rounds,
        "idle_rounds": idle,
        "occupancy": round(stats.occupancy, 4),
        "latency_rounds": {k: round(v, 2) for k, v in latency_percentiles(
            [r.latency_rounds for r in res]).items()},
        "service_rounds": {k: round(v, 2) for k, v in latency_percentiles(
            [r.service_rounds for r in res]).items()},
        "wall_latency_ms": {k: round(v * 1e3, 2)
                            for k, v in latency_percentiles(
            [r.wall_latency_s for r in res]).items()},
        "queries_per_round": round(n / max(clock, 1), 3),
        "sustained_qps": round(qps(n, stats.wall_s), 1),
        "wall_s": round(float(stats.wall_s), 3),
        "host_dispatches": dispatches,
        "host_syncs": getattr(stats, "host_syncs", 0),
        "dispatches_per_query": round(dispatches / n, 3) if n else 0.0,
        "rounds_per_dispatch": round(
            stats.total_rounds / dispatches, 3) if dispatches else 0.0,
        "compile_s": round(float(getattr(stats, "compile_s", 0.0)), 3),
        "warmup_rounds": getattr(stats, "warmup_rounds", 0),
        "injit_admit": bool(getattr(stats, "injit_admit", False)),
        "pages_unique": stats.pages_unique,
        "items_recv": stats.items_recv,
        "props_sent": stats.props_sent,
        "drops_b": stats.drops_b,
        "legs": getattr(stats, "legs", 0),
        "items_by_shard": list(getattr(stats, "items_by_shard", [])),
        "mean_spec_w": round(float(np.mean(stats.spec_trace)), 2)
        if stats.spec_trace else 0.0,
        # robustness counters: overload-shed queries, incomplete
        # (deadline / lost-leg) retirements, guard-quarantined corrupt
        # distances, and the routed clean-legs-per-query histogram.
        # goodput = retired clean / offered: the overload sweeps'
        # headline number (benchmarks/bench_serving.py --chaos)
        "shed": getattr(stats, "shed", 0),
        "truncated": getattr(stats, "truncated", 0),
        "quarantined": getattr(stats, "quarantined", 0),
        "legs_fused_hist": list(getattr(stats, "legs_fused_hist", [])),
        # tiered page store (core/pagestore.py): stall rounds are
        # serving-clock rounds a query aged without working (page
        # misses / fault stalls), prefetch hit rate is touched-before-
        # evicted over staged pages, resident_fraction the device
        # cache size over the logical store (1.0 = untiered)
        "stalls": getattr(stats, "stalls", 0),
        "stall_rounds_per_query": round(
            getattr(stats, "stalls", 0) / n, 3) if n else 0.0,
        "prefetch_hits": getattr(stats, "prefetch_hits", 0),
        "prefetch_issued": getattr(stats, "prefetch_issued", 0),
        "prefetch_hit_rate": round(
            getattr(stats, "prefetch_hits", 0)
            / getattr(stats, "prefetch_issued", 1), 4)
        if getattr(stats, "prefetch_issued", 0) else 0.0,
        "resident_fraction": round(
            float(getattr(stats, "resident_fraction", 1.0)), 4),
        # live index (core/live.py): delta_hits counts result rows
        # answered from the append-only delta segment, tombstoned the
        # deletes applied during the run, epoch_swaps the background
        # reindex swap-ins, swap_stall_rounds the worked rounds thrown
        # away by legs whose frontier died at a swap (re-admitted from
        # the new epoch's entry). All zero on a frozen-index session.
        "delta_hits": getattr(stats, "delta_hits", 0),
        "tombstoned": getattr(stats, "tombstoned", 0),
        "epoch_swaps": getattr(stats, "epoch_swaps", 0),
        "swap_stall_rounds": getattr(stats, "swap_stall_rounds", 0),
        # goodput = retired clean / offered. The three robustness
        # counters partition differently and cannot double-count a
        # query: `truncated` is a per-result flag (each query retires
        # exactly once, so a truncated-and-quarantined query is still
        # one non-clean retirement), `quarantined` counts corrupt
        # *distances* (not queries), and a shed query never enters
        # `results` at all — so the denominator n + shed covers each
        # offered query exactly once (regression-tested in
        # tests/test_torch_scheduler.py).
        "goodput": round(
            sum(1 for r in res if not r.truncated)
            / max(n + getattr(stats, "shed", 0), 1), 4),
    }
