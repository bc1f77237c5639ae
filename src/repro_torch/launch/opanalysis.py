"""Op-stream cost model: operations and bytes of what a call dispatched.

The twin of the reference's ``launch/hloanalysis.py`` (``analyze_hlo``
over compiled HLO text). Eager torch has no program text to parse: the
op stream itself is the program. :class:`OpStream`, a
``TorchDispatchMode``, sees every aten op a call dispatches (the op
audit, ``analysis/op_audit.py``, reads the same stream), and the
hand-written kernels, whose ctypes launches no dispatch mode sees,
report each launch with the cost their wrapper declares from its
shapes (``Kernel.listeners``; the same counts ``chip_smoke.py``'s
bounds are fed). Per op:

  operations  the matmul, convolution and attention formulas of
              ``torch.utils.flop_counter``; one per floating output
              element of the arithmetic pointwise ops (``ELEMENTWISE``)
              and one per input element of the sum reductions;
              a kernel launch's declared count
  bytes       each op reads its inputs and writes its outputs once;
              views are free, as are allocations (``FREE``); gathers
              (``GATHERS``) read only what they produce (and their
              indices); ``index_copy_``, ``index_put_``, ``copy_`` into a
              slice and the in-place scatters write only the update
              (the reference's in-place rule); an expanded operand
              counts its distinct elements; a kernel launch's declared
              bytes

Loops count as they run (every dispatched op is recorded), so no trip
count is parsed: a chunk of K predicated rounds counts K rounds, dead
ones included (an open :class:`OpStream` makes the CPU run them all, as
the card does: core/engine.py ``every_round``).

With ``track_memory`` the stream also follows the lifetime of every
storage an op creates (a weak reference on its storage) and keeps the
peak of their bytes (``peak_bytes``): on "meta" tensors, where nothing
is allocated, that is what the step would hold at its peak beyond what
existed before it (the dry run's temp bytes, ``launch/dryrun.py``).

Known limits: a captured CUDA-graph replay dispatches nothing, so
reports are taken uncaptured (``capture=False``); a report taken while
the stream captures warns. Collective wire bytes are not in the op
stream (a collective counts as its reads and writes): the dry run
(``launch/dryrun.py``) derives them from the sharding rules.

    report = analyze(fn, *args)      # {"flops", "hbm_bytes", "by_op",
                                     #  "kernels", "warnings"}
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# one operation per floating output element
ELEMENTWISE = {
    "add", "add_", "sub", "sub_", "rsub", "mul", "mul_", "div", "div_",
    "neg", "reciprocal", "exp", "log", "sqrt", "rsqrt", "pow", "tanh",
    "sigmoid", "addcmul", "addcmul_", "addcdiv", "addcdiv_", "lerp_",
    "maximum", "minimum", "clamp", "clamp_min", "clamp_max", "abs",
    "square", "silu", "gelu", "erf",
}
# one operation per input element
REDUCTIONS = {"sum", "mean", "cumsum"}
# read only what they produce (plus their indices)
GATHERS = {"index", "index_select", "gather", "take_along_dim",
           "embedding", "take"}
# write only the update (read it, write it; plus the indices)
UPDATES = {"index_copy_", "index_put_", "copy_", "masked_scatter_"}
# read-modify-write of the updated elements
SCATTERS = {"scatter_", "scatter_add_", "scatter_reduce_", "index_add_"}
# allocate without writing, or a view whose schema carries no alias
# annotation (reshape's result on a fresh tensor)
FREE = {"empty", "empty_like", "empty_strided", "new_empty",
        "new_empty_strided", "_unsafe_view"}


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for x in tree for t in _tensors(x)]


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements of ``t`` (a broadcast dimension,
    stride 0, counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@dataclasses.dataclass
class OpRecord:
    """One dispatched op or kernel launch."""

    name: str            # "aten::mul.Tensor" or "kernel::<name>"
    flops: float
    nbytes: float
    syncs: bool          # reads the device from the host
    f64: bool            # a float64 tensor among its operands or outputs
    outputs: tuple       # ((data_ptr, nbytes), ...) of its outputs
    dtype: torch.dtype = None  # its first floating operand's (None: a
                               # kernel launch, or no floating operand)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique",
            "_unique2", "unique_dim", "unique_consecutive",
            "unique_dim_consecutive", "item"}


def op_flops(func, args, kwargs, out) -> float:
    base = func.name().split("::")[-1].split(".")[0]
    fn = flop_registry.get(func.overloadpacket)
    if fn is not None:
        return float(fn(*args, **kwargs, out_val=out))
    outs = _tensors(out)
    if base in ELEMENTWISE:
        return float(sum(t.numel() for t in outs
                         if t.is_floating_point()))
    if base in REDUCTIONS:
        ins = _tensors(args)
        return float(ins[0].numel()) if ins and \
            ins[0].is_floating_point() else 0.0
    return 0.0


def op_bytes(func, args, kwargs, out) -> float:
    """The traffic rules of the module doc."""
    if _is_view(func):
        return 0.0
    base = func.name().split("::")[-1].split(".")[0]
    if base in FREE:
        return 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if base in GATHERS:
        idx = sum(tensor_bytes(t) for t in ins[1:]
                  if not t.is_floating_point())
        return 2.0 * sum(tensor_bytes(t) for t in outs) + idx
    if base in UPDATES:
        # the update is the last tensor operand (copy_'s src,
        # index_copy_'s source, index_put_'s values); indices between
        upd = tensor_bytes(ins[-1]) if len(ins) > 1 else 0
        idx = sum(tensor_bytes(t) for t in ins[1:-1])
        return 2.0 * upd + idx
    if base in SCATTERS:
        upd = tensor_bytes(ins[-1]) if len(ins) > 1 else 0
        idx = sum(tensor_bytes(t) for t in ins[1:-1])
        return 3.0 * upd + idx
    return float(sum(tensor_bytes(t) for t in ins) +
                 sum(tensor_bytes(t) for t in outs))


class OpStream(TorchDispatchMode):
    """Record every op dispatched, and every hand-written kernel launch,
    while open. ``records`` holds one :class:`OpRecord` each, in order.
    ``keep_outputs`` also stores each op's output addresses and sizes
    (the op audit's in-place check)."""

    def __init__(self, keep_outputs: bool = False,
                 track_memory: bool = False):
        super().__init__()
        self.keep_outputs = keep_outputs
        self.track_memory = track_memory
        self.records: list = []
        self.captured = False
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict = {}        # storage key -> weak reference
        self._kernels = ()
        self._rounds = None

    def __enter__(self):
        from repro_torch.core.engine import every_round
        if self.track_memory:
            probe = torch.empty(1, device="meta")
            if probe.untyped_storage() is not probe.untyped_storage():
                raise RuntimeError(
                    "this torch makes a new Python object per storage "
                    "access: OpStream cannot follow storage lifetimes")
        from repro_torch.kernels import KERNELS
        self._kernels = KERNELS
        for k in KERNELS:
            k.listeners.append(self._launched)
        self._rounds = every_round()
        self._rounds.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        for k in self._kernels:
            k.listeners.remove(self._launched)
        self._rounds.__exit__(*exc)
        return super().__exit__(*exc)

    def _launched(self, kernel, cost) -> None:
        flops, nbytes = cost() if cost is not None else (0.0, 0.0)
        self.records.append(OpRecord(f"kernel::{kernel.name}", float(flops),
                                     float(nbytes), False, False, ()))

    def _track(self, outs) -> None:
        """Count the storages that ``outs`` bring to life."""
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live:
                continue
            n = st.nbytes()

            def freed(_, key=key, n=n):
                self._live.pop(key, None)
                self.live_bytes -= n
            self._live[key] = weakref.ref(st, freed)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.track_memory:
            self._track(outs)
        base = func.name().split("::")[-1].split(".")[0]
        to_host = any(t.is_cuda for t in ins) and \
            any(not t.is_cuda for t in outs)
        f64 = any(t.dtype == torch.float64 for t in ins + outs)
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            self.captured = True
        self.records.append(OpRecord(
            func.name(), op_flops(func, args, kwargs, out),
            op_bytes(func, args, kwargs, out),
            base in SYNC_OPS or to_host, f64,
            tuple((t.data_ptr(), t.numel() * t.element_size())
                  for t in outs) if self.keep_outputs else (),
            next((t.dtype for t in ins if t.is_floating_point()), None)))
        return out


def summarize(records) -> dict:
    """The report of a recorded stream: totals, per op and per kernel."""
    by_op = defaultdict(lambda: {"count": 0, "flops": 0.0, "bytes": 0.0})
    for r in records:
        e = by_op[r.name]
        e["count"] += 1
        e["flops"] += r.flops
        e["bytes"] += r.nbytes
    kernels = {n[len("kernel::"):]: {"launches": e["count"],
                                     "flops": e["flops"],
                                     "bytes": e["bytes"]}
               for n, e in by_op.items() if n.startswith("kernel::")}
    return {"flops": sum(r.flops for r in records),
            "hbm_bytes": sum(r.nbytes for r in records),
            "by_op": {n: dict(e) for n, e in sorted(by_op.items())},
            "kernels": kernels}


def analyze(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under an :class:`OpStream` and report
    its operations and bytes (module doc); ``"result"`` holds what
    ``fn`` returned."""
    with OpStream() as stream:
        result = fn(*args, **kwargs)
    report = summarize(stream.records)
    report["warnings"] = [
        "collective wire bytes are not in the op stream (reads + writes "
        "only): the dry run (launch/dryrun.py) derives them from the "
        "sharding rules"]
    if stream.captured:
        report["warnings"].append(
            "ops dispatched while the stream captured a CUDA graph: their "
            "replays dispatch nothing and are not counted")
    report["result"] = result
    return report

