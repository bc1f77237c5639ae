"""Layer 1: AST linter for the port's trace-discipline rules.

Rules (NDS = near-data search), re-expressed for torch and CUDA-graph
capture:

- NDS001  host value mixed with a device tensor in arithmetic or a
          comparison: a numpy array against a tensor silently moves
          the host side's work onto the device (or the device value to
          the host). Fires in hot-path modules and in capture-reachable
          functions.
- NDS002  Python ``if``/``while``/``for``/``and``/``or``/ternary driven
          by a tensor inside a capture-reachable function. Worse under
          capture than under jit: a CUDA-graph capture does not raise,
          it takes one branch at capture time and every replay runs
          that branch. Device control flow goes through
          ``torch.where`` and predicated rounds (core/engine.py).
- NDS003  implicit device sync inside a hot-path module or a
          capture-reachable function: ``.item()`` /
          ``.tolist()`` / ``.cpu()`` / ``.numpy()`` on a tensor,
          ``int()``/``float()``/``bool()`` of a tensor,
          ``np.asarray``/``np.array`` of a tensor, or a host branch on
          a tensor. The sanctioned read is ``utils.to_host`` (one
          batched transfer per chunk boundary), which this rule never
          flags.
- NDS004  device math (``torch.*`` compute) in a designated host-only
          module or ``# nds: host-only`` function. Host plumbing
          (``torch.device``, ``torch.cuda.*``, ``torch.distributed``,
          ``torch.Generator``, ``torch.from_numpy``, ``torch.as_tensor``,
          dtypes) stays allowed.
- NDS005  capture static-key hazards: mutable default arguments on
          capture-reachable functions, and a ``static_key`` passed to
          ``CaptureCache.run`` that holds a mutable literal (a key that
          compares equal today and not tomorrow, or not at all).

Capture roots are the functions passed as ``fn`` to ``CaptureCache.run``
(core/capture.py) and any ``def`` marked ``# nds: captured``;
reachability runs through calls to functions of the same module, names
imported from scanned modules and attributes of scanned modules
imported by name (``T.decode_step``), and nested defs trace with their
parent.

Scope is decided per module by path (``HOT_PATH_KEYS`` /
``HOST_ONLY_KEYS``) or by in-file markers so fixture modules in tests
can opt in: ``# nds: hot-path-module`` / ``# nds: host-only-module``
anywhere in the file, ``# nds: host-only`` or ``# nds: captured`` on a
``def`` line.

Suppressions live in a committed baseline (``lint_baseline.json`` beside
this module) keyed by (file, rule, function, source text) --
line-number independent -- and every entry carries a one-line
justification.

This module imports no torch: it must stay cheap enough to run on every
push and in editor hooks.
"""
from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

RULES = {
    "NDS001": "host value mixed with a device tensor in arithmetic",
    "NDS002": "Python control flow on a tensor in capture-reachable code",
    "NDS003": "implicit device sync in a hot-path module or captured code",
    "NDS004": "device math in a host-only module/function",
    "NDS005": "capture static-key hazard (mutable default / mutable key)",
}

# Module classification by normalized key (path from the last
# "repro_torch" component). Markers extend these sets for fixtures.
HOT_PATH_KEYS = {
    "repro_torch/core/engine.py",
    "repro_torch/core/scheduler.py",
    "repro_torch/core/pagestore.py",
    "repro_torch/core/backend.py",
    "repro_torch/core/dispatch.py",
    "repro_torch/core/traversal.py",
    "repro_torch/core/capture.py",
}
HOST_ONLY_KEYS = {
    "repro_torch/core/metrics.py",
    "repro_torch/ft/restart.py",
    "repro_torch/launch/serve_stream.py",
    "repro_torch/launch/mesh.py",
    "repro_torch/launch/search.py",
}

# torch.* names that are dtypes: static values anywhere
TORCH_DTYPES = {
    "float32", "float64", "float16", "bfloat16", "half", "float", "double",
    "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
    "uint64", "long", "int", "short", "bool", "complex64", "complex128",
    "dtype", "Size", "Tensor", "finfo", "iinfo",
}
# torch.* attributes that are host-side plumbing: static results, and
# fine in host-only code
TORCH_PLUMBING = {
    "device", "cuda", "distributed", "Generator", "no_grad",
    "inference_mode", "set_grad_enabled", "is_grad_enabled", "manual_seed",
    "get_num_threads", "set_num_threads", "backends", "profiler", "utils",
    "is_tensor", "get_default_dtype", "use_deterministic_algorithms",
    "version", "__version__", "multiprocessing", "save", "load",
    "set_printoptions",
}
# plumbing that hands back a tensor: allowed in host-only code, but its
# result is a host tensor (from_numpy) or may live on the device
# (as_tensor, the twin of jax.device_put)
TORCH_HOST_TENSOR = {"from_numpy"}
TORCH_TRANSFER = {"as_tensor"}

# Parameters of capture roots that are static by convention (the
# engine's configuration and the program's bookkeeping).
STATIC_PARAM_NAMES = {
    "self", "params", "geom", "sp", "cfg", "mesh", "part", "spec_cfg",
    "backend", "mode", "dynamic", "routed", "K", "k", "page_size", "opts",
    "name", "rounds", "capture", "per_shard", "device", "dev",
}

SYNC_METHODS = {"item", "tolist"}            # -> a Python value
HOST_METHODS = {"cpu", "numpy"}              # -> a host tensor / array
STATIC_METHODS = {
    "dim", "numel", "size", "data_ptr", "element_size", "is_contiguous",
    "stride", "nelement", "get_device", "is_pinned", "storage_offset",
    "untyped_storage",
}
CAST_BUILTINS = {"int", "float", "bool", "complex"}
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "is_cpu", "layout"}
SANCTIONED_READS = {"to_host"}
MUTABLE_CALLS = {"list", "dict", "set", "bytearray"}

# Tag lattice for the per-function value classifier.
DEVICE, HOST, STATIC, UNKNOWN = "device", "host", "static", "unknown"


def normalize_key(path) -> str:
    """Stable module key: the posix path from the last ``repro_torch``
    part. Keys survive copying the tree somewhere else (tests copy the
    package into a tmp dir and seed violations), so baseline entries
    keep matching."""
    parts = Path(path).as_posix().split("/")
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == "repro_torch":
            return "/".join(parts[i:])
    return "/".join(parts[-2:]) if len(parts) >= 2 else parts[-1]


@dataclass
class Finding:
    path: str
    key: str
    rule: str
    line: int
    func: str
    text: str

    @property
    def suppression_key(self):
        return (self.key, self.rule, self.func, self.text)

    def render(self):
        return (f"{self.path}:{self.line}: {self.rule} [{self.func}] "
                f"{RULES[self.rule]}\n    {self.text}")


@dataclass
class FuncInfo:
    qualname: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    module: "ModuleInfo"
    parent: Optional[str] = None          # enclosing function qualname
    root: bool = False                    # a capture root
    host_only: bool = False               # "# nds: host-only" on def line
    reachable: bool = False
    env: Optional[dict] = None            # final tags, for nested defs
    containers: set = field(default_factory=set)


@dataclass
class ModuleInfo:
    path: str
    key: str
    tree: ast.Module
    lines: list
    aliases: dict = field(default_factory=dict)       # local name -> module
    from_imports: dict = field(default_factory=dict)  # name -> (module, orig)
    device_consts: set = field(default_factory=set)
    static_consts: set = field(default_factory=set)
    funcs: dict = field(default_factory=dict)         # qualname -> FuncInfo
    roots: set = field(default_factory=set)           # root qualnames
    cache_calls: list = field(default_factory=list)   # (call, calling fn)
    hot_path: bool = False
    host_only: bool = False


def _line_text(mod: ModuleInfo, lineno: int) -> str:
    if 1 <= lineno <= len(mod.lines):
        return mod.lines[lineno - 1].strip()
    return ""


def _dotted(node, aliases) -> Optional[str]:
    """Resolve an attribute chain to a dotted module path, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    root = aliases.get(node.id, node.id)
    parts.append(root)
    return ".".join(reversed(parts))


def _is_torch_dotted(dotted: Optional[str]) -> bool:
    return bool(dotted) and (dotted.startswith("torch.") or dotted == "torch")


def _is_numpy_dotted(dotted: Optional[str]) -> bool:
    return bool(dotted) and (
        dotted.startswith("numpy.") or dotted == "numpy")


def _torch_attr(dotted: str) -> str:
    parts = dotted.split(".")
    return parts[1] if len(parts) >= 2 else ""


def _host_ok_torch(dotted: str) -> bool:
    """torch.* names host-only code may use (NDS004)."""
    a = _torch_attr(dotted)
    return a in TORCH_DTYPES or a in TORCH_PLUMBING or \
        a in TORCH_HOST_TENSOR or a in TORCH_TRANSFER


def _mutable_default(node) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(node, ast.Call):
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        return name in MUTABLE_CALLS | {
            "array", "asarray", "tensor", "as_tensor", "zeros", "ones",
            "empty", "full"}
    return False


def _holds_mutable(node) -> bool:
    """Does the expression build a list, dict or set anywhere?"""
    for sub in ast.walk(node):
        if isinstance(sub, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                            ast.DictComp, ast.SetComp)):
            return True
        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name) \
                and sub.func.id in MUTABLE_CALLS:
            return True
    return False


def _is_cache_run(call: ast.Call) -> bool:
    """``<...>.CACHE.run(...)`` / ``CACHE.run(...)``: a CaptureCache."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "run"):
        return False
    v = fn.value
    last = v.attr if isinstance(v, ast.Attribute) else (
        v.id if isinstance(v, ast.Name) else "")
    return last == "CACHE"


def _call_arg(call: ast.Call, pos: int, kw: str):
    if len(call.args) > pos and not any(
            isinstance(a, ast.Starred) for a in call.args[:pos + 1]):
        return call.args[pos]
    for k in call.keywords:
        if k.arg == kw:
            return k.value
    return None


def _collect_module(path) -> Optional[ModuleInfo]:
    src = Path(path).read_text()
    try:
        tree = ast.parse(src)
    except SyntaxError:
        return None
    key = normalize_key(path)
    mod = ModuleInfo(path=str(path), key=key, tree=tree,
                     lines=src.splitlines())
    mod.hot_path = key in HOT_PATH_KEYS or "# nds: hot-path-module" in src
    mod.host_only = key in HOST_ONLY_KEYS or "# nds: host-only-module" in src

    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    mod.aliases[a.asname] = a.name
                else:
                    mod.aliases[a.name.split(".")[0]] = a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                mod.from_imports[a.asname or a.name] = (node.module, a.name)
                if node.module.split(".")[0] in ("torch", "numpy"):
                    # `from torch import nn` -> nn resolves to torch.nn
                    mod.aliases.setdefault(a.asname or a.name,
                                           f"{node.module}.{a.name}")

    # Module-level constants: NAME = torch.*(...) -> device; literal ->
    # static.
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            name = stmt.targets[0].id
            v = stmt.value
            d = _dotted(v.func, mod.aliases) if isinstance(v, ast.Call) \
                else None
            if d and _is_torch_dotted(d) and not _host_ok_torch(d):
                mod.device_consts.add(name)
            elif all(isinstance(n, (ast.Constant, ast.BinOp, ast.UnaryOp,
                                    ast.Tuple, ast.operator, ast.unaryop,
                                    ast.expr_context))
                     for n in ast.walk(v)):
                mod.static_consts.add(name)

    def add_func(node, prefix, parent):
        qual = f"{prefix}{node.name}" if prefix else node.name
        def_text = _line_text(mod, node.lineno)
        fi = FuncInfo(qualname=qual, node=node, module=mod, parent=parent,
                      root="# nds: captured" in def_text,
                      host_only="# nds: host-only" in def_text)
        mod.funcs[qual] = fi
        for child in node.body:
            _walk_defs(child, f"{qual}.", qual)

    def _walk_defs(node, prefix, parent):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            add_func(node, prefix, parent)
        elif isinstance(node, ast.ClassDef):
            for child in node.body:
                _walk_defs(child, f"{prefix}{node.name}.", parent)
        elif hasattr(node, "body") and isinstance(getattr(node, "body"), list):
            for child in node.body:
                _walk_defs(child, prefix, parent)
            for child in getattr(node, "orelse", []) or []:
                _walk_defs(child, prefix, parent)

    for stmt in tree.body:
        _walk_defs(stmt, "", None)

    # CaptureCache.run call sites: the function passed as `fn` is a
    # capture root (resolved in the calling function's scope first).
    if "CACHE" not in src:
        return mod
    for fi in list(mod.funcs.values()):
        for node in _own_nodes(fi.node):
            if isinstance(node, ast.Call) and _is_cache_run(node):
                mod.cache_calls.append((node, fi))
                fn = _call_arg(node, 1, "fn")
                if isinstance(fn, ast.Name):
                    target = _resolve_local(mod, fi, fn.id)
                    if target is not None:
                        target.root = True
    return mod


def _own_nodes(fnode):
    """The nodes of a function body, not descending into nested defs."""
    stack = list(fnode.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


def _resolve_local(mod: ModuleInfo, scope: Optional[FuncInfo], name: str):
    """A function named ``name`` as seen from ``scope``: a nested def of
    the scope or of an enclosing function, then a module-level one."""
    while scope is not None:
        fi = mod.funcs.get(f"{scope.qualname}.{name}")
        if fi is not None:
            return fi
        scope = mod.funcs.get(scope.parent) if scope.parent else None
    return mod.funcs.get(name)


class Workspace:
    """All scanned modules plus the cross-module registries."""

    def __init__(self, modules):
        self.modules = {m.key: m for m in modules}
        self._resolve_imported_consts()
        self._mark_reachability()

    @staticmethod
    def _module_key_of(dotted_module: str) -> str:
        # "repro_torch.core.utils" -> "repro_torch/core/utils.py"
        return dotted_module.replace(".", "/") + ".py"

    def _module_of_name(self, mod, name: str) -> Optional[str]:
        """The key of the scanned module that ``name`` binds in ``mod``
        (``from pkg import mod as name`` or ``import pkg.mod as
        name``), else None."""
        imp = mod.from_imports.get(name)
        dotted = f"{imp[0]}.{imp[1]}" if imp else mod.aliases.get(name)
        if dotted is None:
            return None
        key = self._module_key_of(dotted)
        return key if key in self.modules else None

    def _resolve_imported_consts(self):
        for _ in range(2):  # two passes: one hop of re-export is enough
            for mod in self.modules.values():
                for name, (src_mod, orig) in mod.from_imports.items():
                    src = self.modules.get(self._module_key_of(src_mod))
                    if src is None:
                        continue
                    if orig in src.device_consts:
                        mod.device_consts.add(name)
                    elif orig in src.static_consts:
                        mod.static_consts.add(name)

    def _func_index(self):
        idx = {}
        for mod in self.modules.values():
            for qual, fi in mod.funcs.items():
                idx.setdefault((mod.key, qual.rsplit(".", 1)[-1]), []) \
                    .append(fi)
        return idx

    def _mark_reachability(self):
        idx = self._func_index()
        work = []
        for mod in self.modules.values():
            for fi in mod.funcs.values():
                if fi.root:
                    fi.reachable = True
                    work.append(fi)

        def callees(fi):
            mod = fi.module
            out = []
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load):
                    out.extend(idx.get((mod.key, node.id), []))
                    imp = mod.from_imports.get(node.id)
                    if imp:
                        tgt = self._module_key_of(imp[0])
                        out.extend(idx.get((tgt, imp[1]), []))
                elif isinstance(node, ast.Attribute) and \
                        isinstance(node.value, ast.Name):
                    # ``T.decode_step`` with T a scanned module
                    tgt = self._module_of_name(mod, node.value.id)
                    if tgt is not None:
                        out.extend(idx.get((tgt, node.attr), []))
            # nested defs trace with their parent
            out.extend(sub for sub in mod.funcs.values()
                       if sub.parent == fi.qualname)
            return out

        while work:
            fi = work.pop()
            for callee in callees(fi):
                if not callee.reachable:
                    callee.reachable = True
                    work.append(callee)


class _FuncAnalyzer:
    """Single-pass, flow-ordered value classifier + rule checks."""

    def __init__(self, ws: Workspace, mod: ModuleInfo, fi: FuncInfo,
                 findings: list):
        self.ws, self.mod, self.fi = ws, mod, fi
        self.findings = findings
        self.env = {}
        self.containers = set()     # names bound to tuple/list/dict literals
        self.seen = {}              # id(node) -> its tag
        parent = mod.funcs.get(fi.parent) if fi.parent else None
        if parent is not None and parent.env is not None:
            # a nested def sees its enclosing function's names
            self.env.update(parent.env)
            self.containers |= parent.containers
        args = fi.node.args
        all_params = ([a.arg for a in getattr(args, "posonlyargs", [])] +
                      [a.arg for a in args.args] +
                      [a.arg for a in args.kwonlyargs])
        # a root's *args are the program's tensors; elsewhere *args /
        # **kwargs bind python containers (truthiness is length)
        for va in (args.vararg, args.kwarg):
            if va is not None:
                self.env[va.arg] = DEVICE if fi.root and va is args.vararg \
                    else STATIC
        # a parameter defaulting to a number or string is a host scalar
        positional = [a.arg for a in getattr(args, "posonlyargs", [])] + \
            [a.arg for a in args.args]
        defaults = dict(zip(positional[len(positional) -
                                       len(args.defaults):], args.defaults))
        defaults.update((a.arg, d) for a, d in zip(args.kwonlyargs,
                                                     args.kw_defaults) if d)
        for p in all_params:
            d = defaults.get(p)
            if p in STATIC_PARAM_NAMES or (
                    not fi.root and isinstance(d, ast.Constant) and
                    d.value is not None):
                self.env[p] = STATIC
            elif fi.root:
                self.env[p] = DEVICE
            else:
                self.env[p] = UNKNOWN

    # -- reporting ---------------------------------------------------------
    def flag(self, rule, node):
        self.findings.append(Finding(
            path=self.mod.path, key=self.mod.key, rule=rule,
            line=node.lineno, func=self.fi.qualname,
            text=_line_text(self.mod, node.lineno)))

    # -- tagging -----------------------------------------------------------
    @staticmethod
    def _combine(tags):
        if DEVICE in tags:
            return DEVICE
        if HOST in tags:
            return HOST
        if tags and all(t == STATIC for t in tags):
            return STATIC
        return UNKNOWN

    def _check_mixing(self, node, tags):
        if DEVICE in tags and HOST in tags and \
                (self.mod.hot_path or self.fi.reachable):
            self.flag("NDS001", node)

    def tag(self, node):
        t = self._tag(node)
        self.seen[id(node)] = t
        return t

    def _tag(self, node):  # noqa: C901 - a visitor is one big dispatch
        if node is None or isinstance(node, (ast.Constant, ast.Lambda)):
            return STATIC
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.mod.device_consts:
                return DEVICE
            if node.id in self.mod.static_consts:
                return STATIC
            return UNKNOWN
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                self.tag(node.value)
                return STATIC
            d = _dotted(node, self.mod.aliases)
            if _is_torch_dotted(d):
                return STATIC if _host_ok_torch(d) else DEVICE
            if _is_numpy_dotted(d):
                return HOST
            return self.tag(node.value)
        if isinstance(node, ast.Subscript):
            self.tag(node.slice)
            return self.tag(node.value)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return self._combine([self.tag(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return self._combine([self.tag(v) for v in node.values])
        if isinstance(node, ast.Starred):
            return self.tag(node.value)
        if isinstance(node, ast.Call):
            return self._tag_call(node)
        if isinstance(node, ast.BinOp):
            tags = [self.tag(node.left), self.tag(node.right)]
            self._check_mixing(node, tags)
            return self._combine(tags)
        if isinstance(node, ast.Compare):
            tags = [self.tag(node.left)] + \
                [self.tag(c) for c in node.comparators]
            if all(isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                   for op in node.ops):
                return STATIC  # membership/identity: host-static result
            self._check_mixing(node, tags)
            return self._combine(tags)
        if isinstance(node, ast.BoolOp):
            tags = [self.tag(v) for v in node.values]
            self._check_mixing(node, tags)
            # `a and b` / `a or b` calls bool() on every operand but the
            # last: a host branch on each
            if any(self._truth(v, t) == DEVICE
                   for v, t in zip(node.values[:-1], tags)):
                self._maybe_flag_branch(node, DEVICE)
            return self._combine(tags)
        if isinstance(node, ast.UnaryOp):
            t = self.tag(node.operand)
            if isinstance(node.op, ast.Not):
                # `not t` is bool(t)
                self._maybe_flag_branch(node, self._truth(node.operand, t))
                return STATIC if t == DEVICE else t
            return t
        if isinstance(node, ast.IfExp):
            self._maybe_flag_branch(node, self._truth(node.test,
                                                      self.tag(node.test)))
            return self._combine([self.tag(node.body), self.tag(node.orelse)])
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp)):
            for gen in node.generators:
                self.tag(gen.iter)
            return UNKNOWN
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.tag(v.value)
            return STATIC
        return UNKNOWN

    def _tag_call(self, node: ast.Call):  # noqa: C901
        fn = node.func
        d = _dotted(fn, self.mod.aliases)
        last = (d or "").rsplit(".", 1)[-1] if d else (
            fn.attr if isinstance(fn, ast.Attribute) else "")
        if last in SANCTIONED_READS:
            for a in node.args:
                self.tag(a)
            return HOST                  # the explicit, batched read
        arg_tags = [self.tag(a) for a in node.args] + \
            [self.tag(kw.value) for kw in node.keywords]
        any_device = DEVICE in arg_tags

        if _is_torch_dotted(d):
            a = _torch_attr(d)
            if a in TORCH_HOST_TENSOR:
                return HOST
            if a in TORCH_DTYPES or a in TORCH_PLUMBING:
                return STATIC
            return self._tensor_result(node, arg_tags)
        if _is_numpy_dotted(d):
            if last in ("asarray", "array", "copy") and any_device and \
                    (self.mod.hot_path or self.fi.reachable):
                self.flag("NDS003", node)
            return HOST
        if d and d.split(".")[0] in ("math", "time", "os", "random",
                                     "itertools", "collections",
                                     "functools", "dataclasses"):
            return STATIC

        if isinstance(fn, ast.Name):
            if fn.id in CAST_BUILTINS:
                if any_device and (self.mod.hot_path or self.fi.reachable):
                    self.flag("NDS003", node)
                return STATIC
            if fn.id in ("len", "range", "isinstance", "getattr", "hasattr",
                         "sorted", "enumerate", "zip", "min", "max", "sum",
                         "abs", "str", "repr", "print", "tuple", "list",
                         "dict", "set", "type", "id", "callable"):
                return self._combine(arg_tags) \
                    if fn.id in ("min", "max", "sum", "abs") else STATIC
            target = self._resolve_func(fn.id)
            if target is not None and target.reachable:
                # shape-math helpers over static scalars stay static
                if arg_tags and all(t == STATIC for t in arg_tags):
                    return STATIC
                return HOST if all(t in (STATIC, HOST) for t in arg_tags) \
                    else DEVICE
            return UNKNOWN

        if isinstance(fn, ast.Attribute):
            base_tag = self.tag(fn.value)
            if fn.attr in HOST_METHODS and base_tag in (DEVICE, UNKNOWN):
                # only tensors have .cpu() / .numpy(): unless the value is
                # known to live on the host, this copies from the device
                if self.mod.hot_path or self.fi.reachable:
                    self.flag("NDS003", node)
                return HOST
            if base_tag == DEVICE:
                if fn.attr in SYNC_METHODS:
                    if self.mod.hot_path or self.fi.reachable:
                        self.flag("NDS003", node)
                    return STATIC
                if fn.attr in STATIC_METHODS:
                    return STATIC
                return DEVICE
            chain = []
            cur = fn
            while isinstance(cur, ast.Attribute):
                chain.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name) and cur.id == "self" and \
                    "stepper" in chain:
                return DEVICE  # scheduler dispatch: device results
            if base_tag == HOST:
                return HOST
            return UNKNOWN
        return UNKNOWN

    def _tensor_result(self, call: ast.Call, arg_tags) -> str:
        """A torch call's tensor: on the device named by ``device=`` (a
        literal "cpu" is the host), else where its operands are; a
        factory with no device and no tensor operand makes a host
        tensor, as does a conversion of host data (``as_tensor``,
        ``tensor``). In capture-reachable code a conversion of an
        unknown value is unknown: a copy from host memory cannot be
        captured, so the value is a device tensor passed through or a
        Python number. Elsewhere unknown operands count as device
        ones."""
        for kw in call.keywords:
            if kw.arg == "device":
                v = kw.value
                cpu = isinstance(v, ast.Constant) and v.value == "cpu"
                return HOST if cpu else DEVICE
        d = _dotted(call.func, self.mod.aliases) or ""
        if _torch_attr(d) in ("as_tensor", "tensor") and \
                DEVICE not in arg_tags:
            return UNKNOWN if self.fi.reachable and \
                UNKNOWN in arg_tags[:1] else HOST
        if DEVICE in arg_tags or UNKNOWN in arg_tags:
            return DEVICE
        return HOST

    def _resolve_func(self, name):
        fi = _resolve_local(self.mod, self.fi, name)
        if fi is not None:
            return fi
        imp = self.mod.from_imports.get(name)
        if imp:
            src = self.ws.modules.get(Workspace._module_key_of(imp[0]))
            if src:
                return src.funcs.get(imp[1])
        return None

    # -- statements --------------------------------------------------------
    def _is_container(self, node) -> bool:
        """A tuple, list, dict or set (of tensors, maybe): its truth is
        its length, not a tensor's value."""
        if isinstance(node, (ast.Tuple, ast.List, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp)):
            return True
        if isinstance(node, ast.IfExp):
            return self._is_container(node.body) and \
                self._is_container(node.orelse)
        return isinstance(node, ast.Name) and node.id in self.containers

    def _truth(self, node, tag):
        """The tag of ``bool(node)``'s operand: containers are static;
        ``a and b`` tests ``a`` itself (flagged there) and then ``b``."""
        if isinstance(node, ast.BoolOp):
            last = node.values[-1]
            return self._truth(last, self.seen.get(id(last), UNKNOWN))
        return STATIC if self._is_container(node) else tag

    def _maybe_flag_branch(self, node, test_tag):
        if test_tag != DEVICE:
            return
        if self.fi.reachable:
            self.flag("NDS002", node)
        elif self.mod.hot_path:
            self.flag("NDS003", node)  # host branch on a tensor == sync

    def _assign_target(self, target, tag):
        if isinstance(target, ast.Name):
            self.env[target.id] = tag
        elif isinstance(target, (ast.Tuple, ast.List)):
            for e in target.elts:
                self._assign_target(e, tag)
        elif isinstance(target, ast.Starred):
            self._assign_target(target.value, tag)

    def run(self):
        self._visit_block(self.fi.node.body)
        self.fi.env, self.fi.containers = self.env, self.containers

    def _visit_block(self, stmts):
        for stmt in stmts:
            self._visit_stmt(stmt)

    def _visit_stmt(self, stmt):  # noqa: C901
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.env[stmt.name] = STATIC  # analyzed as its own function
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    if self._is_container(stmt.value):
                        self.containers.add(t.id)
                    else:
                        self.containers.discard(t.id)
            tag = self.tag(stmt.value)
            if isinstance(stmt.value, ast.Tuple) and \
                    len(stmt.targets) == 1 and \
                    isinstance(stmt.targets[0], (ast.Tuple, ast.List)) and \
                    len(stmt.targets[0].elts) == len(stmt.value.elts):
                for t, v in zip(stmt.targets[0].elts, stmt.value.elts):
                    self._assign_target(t, self.tag(v))
            else:
                for t in stmt.targets:
                    self._assign_target(t, tag)
            return
        if isinstance(stmt, ast.AugAssign):
            tags = [self.tag(stmt.target), self.tag(stmt.value)]
            self._check_mixing(stmt, tags)
            self._assign_target(stmt.target, self._combine(tags))
            return
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._assign_target(stmt.target, self.tag(stmt.value))
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._maybe_flag_branch(stmt, self._truth(stmt.test,
                                                      self.tag(stmt.test)))
            self._visit_block(stmt.body)
            self._visit_block(stmt.orelse)
            return
        if isinstance(stmt, ast.For):
            self._maybe_flag_branch(stmt, self.tag(stmt.iter))
            self._assign_target(stmt.target, UNKNOWN)
            self._visit_block(stmt.body)
            self._visit_block(stmt.orelse)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self.tag(item.context_expr)
                if item.optional_vars is not None:
                    self._assign_target(item.optional_vars, UNKNOWN)
            self._visit_block(stmt.body)
            return
        if isinstance(stmt, ast.Try):
            self._visit_block(stmt.body)
            for h in stmt.handlers:
                self._visit_block(h.body)
            self._visit_block(stmt.orelse)
            self._visit_block(stmt.finalbody)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)):
            if stmt.value is not None:
                self.tag(stmt.value)
            return
        if isinstance(stmt, ast.Assert):
            self.tag(stmt.test)
            return
        if isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                self.tag(t)
            return
        if isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.tag(stmt.exc)
            return
        # Import / Pass / Global / Nonlocal / Break / Continue: nothing


def _check_nds004(mod: ModuleInfo, fi: FuncInfo, findings: list):
    """Flag torch compute inside host-only scope."""
    seen_lines = set()
    for node in ast.walk(fi.node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node is not fi.node:
            continue  # nested defs get their own pass
        if not isinstance(node, ast.Attribute):
            continue
        d = _dotted(node, mod.aliases)
        if not _is_torch_dotted(d) or _host_ok_torch(d):
            continue
        if node.lineno in seen_lines:
            continue
        seen_lines.add(node.lineno)
        findings.append(Finding(
            path=mod.path, key=mod.key, rule="NDS004", line=node.lineno,
            func=fi.qualname, text=_line_text(mod, node.lineno)))


def _check_nds005(mod: ModuleInfo, fi: FuncInfo, findings: list):
    node = fi.node
    if fi.reachable:
        defaults = list(node.args.defaults) + \
            [d for d in node.args.kw_defaults if d is not None]
        for d in defaults:
            if _mutable_default(d):
                findings.append(Finding(
                    path=mod.path, key=mod.key, rule="NDS005",
                    line=d.lineno, func=fi.qualname,
                    text=_line_text(mod, d.lineno)))


def _assigned_values(fnode, name: str):
    """Values assigned to ``name`` in a function body, not descending
    into nested defs."""
    for n in _own_nodes(fnode):
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == name for t in n.targets):
            yield n.value


def _check_static_keys(mod: ModuleInfo, findings: list):
    """NDS005: a CaptureCache.run static_key holding a mutable literal,
    directly or through a name assigned in the calling function."""
    for call, fi in mod.cache_calls:
        key = _call_arg(call, 2, "static_key")
        if key is None:
            continue
        values = [key]
        if isinstance(key, ast.Name):
            values = list(_assigned_values(fi.node, key.id))
        if any(_holds_mutable(v) for v in values):
            findings.append(Finding(
                path=mod.path, key=mod.key, rule="NDS005",
                line=call.lineno, func=fi.qualname,
                text=_line_text(mod, call.lineno)))


def iter_py_files(paths):
    for p in paths:
        p = Path(p)
        if p.is_dir():
            for f in sorted(p.rglob("*.py")):
                if "__pycache__" not in f.parts:
                    yield f
        elif p.suffix == ".py":
            yield p


def lint_paths(paths) -> list:
    """Scan files/dirs and return the full (unsuppressed) finding list."""
    modules = [m for m in (_collect_module(f) for f in iter_py_files(paths))
               if m is not None]
    ws = Workspace(modules)
    findings = []
    for mod in ws.modules.values():
        for fi in mod.funcs.values():
            if mod.host_only or fi.host_only:
                _check_nds004(mod, fi, findings)
            _check_nds005(mod, fi, findings)
            _FuncAnalyzer(ws, mod, fi, findings).run()
        _check_static_keys(mod, findings)
    findings.sort(key=lambda f: (f.key, f.line, f.rule))
    return findings


# -- suppression baseline ---------------------------------------------------

def load_baseline(path):
    """Load suppressions; entries without a justification are invalid."""
    data = json.loads(Path(path).read_text())
    entries = {}
    for e in data.get("suppressions", []):
        if not str(e.get("why", "")).strip():
            raise ValueError(
                f"baseline entry without justification: {e!r}")
        entries[(e["file"], e["rule"], e["func"], e["text"])] = e
    return entries


def apply_baseline(findings, baseline):
    """Split findings into (active, suppressed); also report stale keys."""
    active, suppressed, used = [], [], set()
    for f in findings:
        if f.suppression_key in baseline:
            suppressed.append(f)
            used.add(f.suppression_key)
        else:
            active.append(f)
    stale = [k for k in baseline if k not in used]
    return active, suppressed, stale


def run_lint(paths, baseline_path=None, show_all=False, out=None) -> int:
    """CLI body: returns the process exit code."""
    import sys
    out = out or sys.stdout
    findings = lint_paths(paths)
    suppressed, stale = [], []
    if baseline_path and Path(baseline_path).exists() and not show_all:
        baseline = load_baseline(baseline_path)
        findings, suppressed, stale = apply_baseline(findings, baseline)
    for f in findings:
        print(f.render(), file=out)
    if suppressed:
        print(f"{len(suppressed)} finding(s) suppressed by baseline",
              file=out)
    for k in stale:
        print(f"note: stale baseline entry (no longer matches): {k}",
              file=out)
    if findings:
        print(f"FAIL: {len(findings)} trace-discipline finding(s)", file=out)
        return 1
    print("OK: no trace-discipline findings", file=out)
    return 0
