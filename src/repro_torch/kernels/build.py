"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C launch function and is compiled
by ``nvcc`` for ``sm_90a`` into its own shared library, loaded with
ctypes — no PyTorch headers, so a build takes seconds, not the minutes a
``torch.utils.cpp_extension`` build of the same code would. All sources
compile in parallel (one ``nvcc`` each, started together) at first use,
into ``build/`` beside this file; library names carry a hash of their
source, so an edited source never loads a stale build.

A :class:`Kernel` is one wrapper's handle: its name, the Pallas kernel it
replaces, its C entry point, and a plain integer count of its launches.
The count grows by one exactly where the wrapper launches its kernel.
A launch made while the current stream captures a CUDA graph runs
nothing: it counts in ``recorded`` instead, and the graph's replays add
what they launch through :meth:`Kernel.credit` (core/capture.py).
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
SOURCES = ("paged_distance.cu", "bitonic.cu", "flash_attention.cu",
           "flash_attention_bwd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of each C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "paged_distance_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P),
    "bitonic_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P),
    "merge_unsorted_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P),
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _F, _I, _P),
    "flash_attention_bwd_launch": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                   _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                                   _I, _F, _I, _I, _I, _P),
}

# the bf16 instantiations of the distance kernel take the same arguments
for _dt in ("bf16q", "bf16db", "bf16q_bf16db"):
    SIGNATURES[f"paged_distance_{_dt}_launch"] = \
        SIGNATURES["paged_distance_launch"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas: registers, spills, shared memory per kernel) of
# each source this process compiled
BUILD_LOGS: dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset and no "
                           "nvcc on PATH): cannot build the CUDA kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> float:
    """Compile every source that has no current library, all at once,
    and load them. Returns the seconds spent (0.0 when all were loaded)."""
    with _lock:
        if len(_libs) == len(SOURCES):
            return 0.0
        t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for name in SOURCES:
            src = CSRC / name
            lib = _lib_path(src)
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
                jobs[name] = (subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True), tmp, lib)
        errors = []
        for name, (proc, tmp, lib) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc {name} failed ({proc.returncode}):\n{log}")
            else:
                BUILD_LOGS[name] = log
                os.replace(tmp, lib)
        if errors:
            raise RuntimeError("\n".join(errors))
        for name in SOURCES:
            lib = ctypes.CDLL(str(_lib_path(CSRC / name)))
            for fn, argtypes in SIGNATURES.items():
                if hasattr(lib, fn):
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return time.perf_counter() - t0


@dataclasses.dataclass
class Kernel:
    """One kernel wrapper's handle and launch count."""

    name: str
    source: str        # csrc file
    entry: str         # C launch function
    replaces: str      # the Pallas kernel it ports (file:line)
    launches: int = 0
    recorded: int = 0  # launches recorded into CUDA graphs under capture
    # called as fn(kernel, cost) after each launch, where cost is the
    # wrapper's () -> (operations, bytes) or None (launch/opanalysis.py)
    listeners: list = dataclasses.field(default_factory=list, repr=False)

    def launch(self, *args, cost=None) -> None:
        """Call the C entry point on the current stream; raise if the
        launch was refused. ``cost``: the wrapper's () -> (operations,
        bytes) of this launch, from its shapes, read by listeners."""
        build_all()
        fn = getattr(_libs[self.source], self.entry)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with "
                               f"cudaError {err}")
        if torch.cuda.is_current_stream_capturing():
            self.recorded += 1
        else:
            self.launches += 1
        for listener in self.listeners:
            listener(self, cost)

    def shape_only(self, cost=None) -> None:
        """A launch on "meta" tensors (a plan: ``launch/dryrun.py``):
        nothing runs and ``launches`` does not move; listeners see it
        with its ``cost``, as they see a card launch."""
        for listener in self.listeners:
            listener(self, cost)

    def credit(self, n: int) -> None:
        """Count ``n`` launches a CUDA graph replay made."""
        self.launches += n


def check_cuda_operands(name: str, specs: dict) -> None:
    """Raise unless every (tensor, dtype, shape) is a contiguous tensor of
    that dtype and shape on the current CUDA device."""
    dev = torch.device("cuda", torch.cuda.current_device())
    for arg, (x, dtype, shape) in specs.items():
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, the kernel "
                             f"runs on {dev}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


KERNEL_MODES = ("auto", "cuda", "ref")


def resolve_kernel_mode(mode: str, x: torch.Tensor) -> str:
    """'auto' -> 'cuda' for a CUDA tensor, 'ref' (the plain version) for a
    CPU tensor, 'meta' for a "meta" tensor (a plan: the kernel wrappers
    allocate their outputs on meta and report the launch's declared cost
    to ``Kernel.listeners``; nothing runs). 'cuda' on a CPU or meta
    tensor raises: there is no fallback."""
    if mode not in KERNEL_MODES:
        raise ValueError(f"kernel mode {mode!r} not in {KERNEL_MODES}")
    if mode == "auto":
        return "cuda" if x.is_cuda else "meta" if x.is_meta else "ref"
    if mode == "cuda" and not x.is_cuda:
        raise ValueError(f"kernel mode 'cuda' needs CUDA tensors, got a "
                         f"tensor on {x.device}")
    return mode
