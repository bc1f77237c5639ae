"""Round chunks captured as CUDA graphs: the device paces the round loop.

The reference runs its round loops as ``lax.while_loop`` inside one jit
call (``search_sim``, ``engine_run_chunk[_admit]``), so the host waits on
the device once per chunk, not once per round (the paper's §V: the host
stays off the round-to-round critical path). The port writes each chunk
as K *predicated* rounds (core/engine.py): every round computes its loop
condition ``go`` on the device, and every value the loop carries
advances only where ``go`` holds, so the chunk has no data-dependent
control flow left. Such a chunk can be captured once with
``torch.cuda.CUDAGraph`` and replayed: one replay launches its K rounds
— some 370 kernels each at the sift-1b stand-in's shapes — with one
host call.

:meth:`CaptureCache.run` keeps one entry per chunk program, keyed by the
caller (the function, its static configuration, the ``data_ptr`` of
every tensor the program reads in place) and by the shapes and dtypes of
the per-call operands. An entry holds *static* input buffers, the graph
and its *static* outputs: a call copies its operands into the inputs
(skipping an operand that already is the input buffer), replays, and
returns the outputs. The outputs are overwritten by the entry's next
call, so a caller either feeds them straight back (the schedulers'
state) or copies what it keeps. On the CPU an entry holds the same
static buffers and runs the program eagerly into them, so the CPU tests
see the buffer semantics the card has.

Capture: the operands are cloned into the static inputs, the program
runs once eagerly on a side stream (it builds the kernels, queries the
card for their launch grids and fills the caching allocator), then once
under capture (the caching allocator keeps its blocks: see ``_build``). What the kernels' wrappers decide from their operands is
decided then and baked in: ``paged_distances`` picks 16-byte copies from
its operands' alignment, and every operand it gets inside a round is a
fresh allocation from the graph's pool or a const, both 16-byte
aligned. The ``cudaFuncSetAttribute`` call of its launch function is
legal under capture. A capture that fails raises; there is no eager
fallback on a CUDA tensor. ``capture=False`` runs the program eagerly
on the card, outside any cache: the proof path that captured and
uncaptured runs agree.

State written in place: a chunk program returns its state, but the
serving decode step (launch/serve.py) writes the KV cache, the SSM and
conv states and the position where they lie. Such a program names those
tensors as ``state``: they are cloned before the warm-up and copied
back after it, so the warm-up leaves no trace in them and the first
replay steps them once, not twice. On the CPU such an entry runs the
warm-up too, so the CPU tests see that it leaves the state as it found
it. A serving session drops its entries when it ends (:meth:`drop`)
rather than leaving them, and the memory pools of their graphs, to the
least-recently-used order.

Collectives: a mesh chunk (core/engine.py on an engine mesh) holds
``torch.distributed`` all-to-alls, all-reduces and all-gathers, which
the graph captures once NCCL's communicator exists (at world 1 NCCL
runs them as device copies): the mesh runs one collective eagerly
before any capture (``EngineMesh.warm``), and the
chunk's key holds the rank, the world size and the mesh's generation,
so a graph is never replayed under another process group than the one
it was captured with. On the CPU (``gloo``) the entry runs them
eagerly, in the same order on every rank.

Launch accounting: a kernel wrapper called while its stream captures
records its launch (``Kernel.recorded``) instead of counting it, since
nothing ran. The entry keeps the launches of one replay per kernel,
and every replay adds them to the kernels' counts: a replay runs all K
rounds of the chunk, dead ones included (masked rounds, see
core/engine.py), so counts grow by the launches of K rounds per replay.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Optional

import torch

# entries kept: a serving session adds one per chunk program it runs
# (its staged pending queue is in the key), so old sessions' graphs and
# their memory pools are dropped in least-recently-used order
MAX_ENTRIES = 8


def tree_map(fn, tree):
    """``fn`` over the tensors of a tree of tuples, named tuples, lists
    and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    vals = [tree_map(fn, x) for x in tree]
    return tree._make(vals) if hasattr(tree, "_make") else type(tree)(vals)


def tree_leaves(tree) -> list:
    """The tensors of a tree, in :func:`tree_map`'s order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for x in tree for leaf in tree_leaves(x)]


def tensor_ptrs(*tensors) -> tuple:
    """Cache-key part of tensors a program reads in place (consts, the
    staged pending queue): their addresses, shapes and dtypes."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


@dataclasses.dataclass
class Entry:
    """One captured chunk program."""

    inputs: tuple                    # static input buffers
    outputs: Any                     # static outputs (a tree of tensors)
    graph: Optional[torch.cuda.CUDAGraph]   # None on the CPU
    rounds: int                      # rounds one call runs on the device
    launches: dict                   # per replay, by kernel name


@dataclasses.dataclass
class CaptureStats:
    """What the cache did since the last :meth:`CaptureCache.reset_stats`:
    ``rounds`` counts every round the device ran under the cache (the
    captures' eager warm-ups, ``warm_rounds`` of them, and every
    replay's K rounds)."""

    captures: int = 0
    replays: int = 0
    rounds: int = 0
    warm_rounds: int = 0


class CaptureCache:
    """Chunk programs captured once per key and replayed (module doc)."""

    def __init__(self, max_entries: int = MAX_ENTRIES):
        self.max_entries = max_entries
        self.entries: collections.OrderedDict = collections.OrderedDict()
        self.stats = CaptureStats()
        # called with the program name of every entry built (a capture
        # on a card, the eager entry on the CPU): analysis.CaptureGuard
        self.listeners: list = []

    def reset_stats(self) -> None:
        self.stats = CaptureStats()

    def count(self, name: str) -> int:
        """Entries of the program ``name`` the cache holds."""
        return sum(1 for key in self.entries if key[0] == name)

    def drop(self, name: str, static_key: tuple) -> int:
        """Drop the entries of program ``name`` built under
        ``static_key`` (any operand shapes); returns how many."""
        keys = [k for k in self.entries if k[:2] == (name, static_key)]
        for k in keys:
            del self.entries[k]
        return len(keys)

    def run(self, name: str, fn: Callable, static_key: tuple, args: tuple,
            rounds: int, capture: bool = True, state: tuple = ()):
        """``fn(*args)`` (a tree of tensors), through the entry of
        ``(name, static_key, the args' shapes and dtypes)``: built on the
        first call, replayed after. ``rounds`` is the number of rounds
        one call runs on the device; ``state`` the tensors ``fn`` writes
        in place, which the build's warm-up leaves as it found them
        (module doc). ``capture=False`` calls ``fn`` eagerly outside the
        cache."""
        if not capture:
            return fn(*args)
        dev = args[0].device
        key = (name, static_key, str(dev),
               tuple((tuple(a.shape), a.dtype) for a in args))
        entry = self.entries.get(key)
        if entry is None:
            entry = self._build(name, fn, args, rounds, state)
            self.entries[key] = entry
            while len(self.entries) > self.max_entries:
                self.entries.popitem(last=False)
            self.stats.captures += 1
            for listener in self.listeners:
                listener(name)
        else:
            self.entries.move_to_end(key)
            for buf, a in zip(entry.inputs, args):
                if buf.data_ptr() != a.data_ptr():
                    buf.copy_(a)
        self._replay(entry, fn)
        return entry.outputs

    def _warm(self, fn, inputs, rounds, state) -> None:
        """One eager run of ``fn`` before capture (on a side stream on a
        card), with ``state`` put back as it was."""
        saved = [t.clone() for t in state]
        if inputs[0].device.type == "cuda":
            cur = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                fn(*(a.clone() for a in inputs))
            cur.wait_stream(side)
        else:
            fn(*(a.clone() for a in inputs))
        for t, s in zip(state, saved):
            t.copy_(s)
        self.stats.rounds += rounds
        self.stats.warm_rounds += rounds

    def _build(self, name, fn, args, rounds, state=()) -> Entry:
        inputs = tuple(a.clone(memory_format=torch.contiguous_format)
                       for a in args)
        if inputs[0].device.type != "cuda":
            if state:
                self._warm(fn, inputs, rounds, state)
            return Entry(inputs, None, None, rounds, {})
        from repro_torch.kernels import KERNELS
        self._warm(fn, inputs, rounds, state)
        before = {k.name: k.recorded for k in KERNELS}
        graph = torch.cuda.CUDAGraph()
        # captured on a side stream as ``torch.cuda.graph`` does, without
        # its ``empty_cache()``: that hands every cached block back to the
        # driver, and the next eager step (a serving session's prefill)
        # then waits on cudaMalloc for each buffer again
        torch.cuda.synchronize()
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                graph.capture_begin()
                try:
                    outputs = fn(*inputs)
                finally:
                    graph.capture_end()
        except RuntimeError as e:
            raise RuntimeError(f"capture of the {name} chunk failed: "
                               f"{e}") from e
        launches = {k.name: k.recorded - before[k.name] for k in KERNELS}
        for k, n in launches.items():
            if n % rounds:
                raise RuntimeError(
                    f"capture of the {name} chunk recorded {n} {k} "
                    f"launches over {rounds} rounds")
        return Entry(inputs, outputs, graph, rounds, launches)

    def _replay(self, entry: Entry, fn) -> None:
        self.stats.replays += 1
        self.stats.rounds += entry.rounds
        if entry.graph is None:                   # the CPU: run eagerly
            out = fn(*entry.inputs)
            if entry.outputs is None:
                entry.outputs = tree_map(torch.clone, out)
            else:
                for buf, new in zip(tree_leaves(entry.outputs),
                                    tree_leaves(out)):
                    buf.copy_(new)
            return
        entry.graph.replay()
        from repro_torch.kernels import KERNELS
        for k in KERNELS:
            k.credit(entry.launches[k.name])


#: the process's chunk programs (search_sim, the stepper's chunks); like
#: the kernels' launch counts, one per process
CACHE = CaptureCache()
