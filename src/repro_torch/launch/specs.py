"""Cell plans: (architecture x input shape x mesh) -> a step function and
its planned inputs (the reference's ``launch/specs.py``).

A planned input is a :class:`Planned`: a "meta" tensor of the input's
global shape and dtype (nothing is allocated, as with the reference's
``ShapeDtypeStruct``) paired with its partition spec from the sharding
rules (``models/sharding.py``). The parameters are planned in the port's
layout (per-layer lists, each spec without the reference's leading
"layers" entry); the factored second moment of a stacked leaf is planned
stacked, as the optimizer holds it (``optim/adamw.py``). The dry run
(``launch/dryrun.py``) runs a plan's step at the per-device shapes these
specs give.

``POLICIES`` keeps the reference's per-arch training policy (grad-accum,
grouped remat, moment dtypes, loss chunk) value for value. The reference
tuned them to fit a 16 GiB TPU v5e chip; the port's device budget,
``HBM_PER_CHIP``, is the H100's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models import transformer as T
from repro_torch.models.convert import STACKED
from repro_torch.models.params import (local_shape, logical_pspec, pspec_of,
                                       tree_paths_map)
from repro_torch.models.sharding import MeshRules, make_rules
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.trainer import TrainConfig, make_train_step

# NVIDIA H100 SXM5 80GB: 80 GB of HBM3 (NVIDIA H100 Tensor Core GPU
# datasheet), taken as 80e9 bytes
HBM_PER_CHIP = 80 * 10**9


# --------------------------------------------------------------------------
# Per-arch training memory policy: the reference's values, tuned there
# for a 16 GiB v5e chip
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ArchPolicy:
    grad_accum: int = 1
    scan_groups: int = 1
    loss_chunk: int = 1024
    m_dtype: Any = torch.float32
    v_dtype: Any = torch.float32
    factored_v: bool = False
    param_dtype: Any = torch.bfloat16
    cap_factor: float = 1.25


POLICIES = {
    "llama3-405b": ArchPolicy(grad_accum=8, scan_groups=14, loss_chunk=512,
                              m_dtype=torch.bfloat16, factored_v=True),
    "yi-34b": ArchPolicy(grad_accum=8, scan_groups=10, loss_chunk=512),
    "gemma2-27b": ArchPolicy(grad_accum=8, scan_groups=2, loss_chunk=512),
    "dbrx-132b": ArchPolicy(grad_accum=8, scan_groups=8, loss_chunk=512,
                            m_dtype=torch.bfloat16),
    "mixtral-8x7b": ArchPolicy(grad_accum=8, scan_groups=4, loss_chunk=512),
    "llava-next-mistral-7b": ArchPolicy(grad_accum=8, scan_groups=4,
                                        loss_chunk=512),
    "zamba2-1.2b": ArchPolicy(grad_accum=2),
    "mamba2-780m": ArchPolicy(grad_accum=4),
    "gemma3-1b": ArchPolicy(loss_chunk=512),
    "seamless-m4t-medium": ArchPolicy(loss_chunk=512),
}

# encoder length used for encdec decode shapes (the 32k/500k cache is the
# decoder's; the cross-attention context is a 4096-frame utterance)
ENCDEC_DECODE_ENC_LEN = 4096


def policy_for(arch: str) -> ArchPolicy:
    return POLICIES.get(arch, ArchPolicy())


@dataclasses.dataclass(frozen=True)
class Planned:
    """A planned tensor: ``tensor`` on "meta" (global shape and dtype)
    and its partition spec ``pspec``."""

    tensor: torch.Tensor
    pspec: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.tensor.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def local_shape(self, mesh) -> tuple:
        """The shape one device holds."""
        return local_shape(self.shape, self.pspec, axis_sizes(mesh))

    def local_bytes(self, mesh) -> int:
        n = 1
        for d in self.local_shape(mesh):
            n *= d
        return n * self.tensor.element_size()


def planned(shape, dtype, pspec) -> Planned:
    return Planned(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                   tuple(pspec))


def planned_leaves(tree) -> list:
    """The :class:`Planned` leaves of a tree of dicts, lists and
    tuples."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in planned_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in planned_leaves(v)]
    return [tree] if isinstance(tree, Planned) else []


@dataclasses.dataclass
class CellPlan:
    arch: str
    shape: str
    kind: str                       # train | prefill | decode
    step_fn: Callable
    args: tuple                     # trees of Planned
    note: str = ""
    cfg: ArchConfig = None
    rules: MeshRules = None
    opts: T.ModelOpts = None
    policy: ArchPolicy = None
    rules_kind: str = ""            # the rules' kind (decode_long too)


class Skip(Exception):
    """Cell not applicable (reason in str); recorded, not an error."""


def rules_kind(shape_name: str) -> str:
    shp = SHAPES[shape_name]
    if shp.kind == "decode" and shp.seq_len > 65536:
        return "decode_long"
    return shp.kind


# logical axis names of the decode cache's entries (the reference's
# ``cache_spec``): k/v (and xk/xv) per layer, ssm and conv stacked
_KVN = ("batch", "seq", "kv_heads", "cache_hd")
CACHE_NAMES = {"k": _KVN, "v": _KVN, "xk": _KVN, "xv": _KVN,
               "ssm": ("layers", "batch", "ssm_heads", None, None),
               "conv": ("layers", "batch", None, "ssm_inner"),
               "pos": (), "enc_len": ()}


def cache_structs(cfg: ArchConfig, batch: int, cache_len: int, rules, *,
                  enc_len: int = 0, dtype=torch.bfloat16) -> dict:
    """The decode cache of ``T.cache_spec`` planned: k/v bf16 lists,
    ssm/conv f32, pos and enc_len int32 scalars."""
    out = {}
    for name, shape in T.cache_spec(cfg, batch, cache_len,
                                    enc_len=enc_len).items():
        pspec = logical_pspec(CACHE_NAMES[name], rules.acts)
        if name in ("pos", "enc_len"):
            out[name] = planned((), torch.int32, ())
        elif name in ("ssm", "conv"):
            out[name] = planned(shape, torch.float32, pspec)
        else:
            out[name] = [planned(s, dtype, pspec) for s in shape]
    return out


def _batch_pspec(rules) -> tuple:
    b = rules.acts.lookup("batch")
    return (b,) if b is not None else ()


def input_specs(arch: str, shape_name: str, mesh) -> dict:
    """Planned stand-ins for every model input of this cell."""
    shp = SHAPES[shape_name]
    cfg = get_config(arch)
    return _inputs(cfg, shp.kind, shp.global_batch, shp.seq_len,
                   make_rules(cfg, mesh, kind=rules_kind(shape_name)))


def _inputs(cfg: ArchConfig, kind: str, B: int, S: int, rules) -> dict:
    bp = _batch_pspec(rules)
    out = {}
    if kind in ("train", "prefill"):
        out["tokens"] = planned((B, S), torch.int32, bp)
        if kind == "train":
            out["labels"] = planned((B, S), torch.int32, bp)
        if cfg.family == "vlm":
            out["frontend"] = planned((B, cfg.frontend_tokens, cfg.d_model),
                                      torch.float32, bp)
        elif cfg.family == "encdec":
            out["frontend"] = planned((B, S, cfg.d_model), torch.float32, bp)
        if kind == "prefill":
            out["cache"] = cache_structs(
                cfg, B, S, rules, enc_len=S if cfg.family == "encdec" else 0)
    else:  # decode
        out["tokens"] = planned((B, 1), torch.int32, bp)
        out["cache"] = cache_structs(
            cfg, B, S, rules,
            enc_len=ENCDEC_DECODE_ENC_LEN if cfg.family == "encdec" else 0)
    return out


def param_structs(cfg: ArchConfig, mesh, rules, dtype):
    return tree_paths_map(
        lambda s: planned(s.shape, dtype or s.dtype,
                          pspec_of(s, rules.params)),
        T.model_spec(cfg))


def _factored_v(shape, axes) -> dict:
    """The reference's factored statistics of a leaf of ``shape`` whose
    untrimmed param axes are ``axes``: r/c for two or more dims, else a
    full ``f`` (``src/repro/launch/specs.py:139-166``)."""
    def trim(a):
        while a and a[-1] is None:
            a = a[:-1]
        return a
    if len(shape) >= 2:
        return {"r": planned(shape[:-1], torch.float32, trim(axes[:-1])),
                "c": planned(shape[:-2] + shape[-1:], torch.float32,
                             trim(axes[:-2] + axes[-1:]))}
    return {"f": planned(shape, torch.float32, trim(axes))}


def opt_structs(cfg: ArchConfig, mesh, rules, pol: ArchPolicy) -> dict:
    """The AdamW state that ``optim.adamw.init_opt`` makes, planned: m
    (and an unfactored v) per leaf, a factored v on the reference's
    stacked view of the stacked subtrees."""
    spec = T.model_spec(cfg)

    def axes(s):
        return tuple(rules.params.lookup(n) for n in s.names)

    m = tree_paths_map(lambda s: planned(s.shape, pol.m_dtype,
                                         pspec_of(s, rules.params)), spec)
    if pol.factored_v:
        v = {}
        for k, sub in spec.items():
            if k in STACKED:
                v[k] = tree_paths_map(
                    lambda s, L=len(sub): _factored_v(
                        (L,) + s.shape, (None,) + axes(s)), sub[0])
            else:
                v[k] = tree_paths_map(
                    lambda s: _factored_v(s.shape, axes(s)), sub)
    else:
        v = tree_paths_map(lambda s: planned(s.shape, pol.v_dtype,
                                             pspec_of(s, rules.params)),
                           spec)
    return {"m": m, "v": v, "step": planned((), torch.int32, ())}


def model_opts(shape_name: str, pol: ArchPolicy) -> T.ModelOpts:
    train = SHAPES[shape_name].kind == "train"
    return T.ModelOpts(remat="full" if train else "none",
                       scan_groups=pol.scan_groups if train else 1,
                       loss_chunk=pol.loss_chunk,
                       act_dtype=torch.bfloat16,
                       cap_factor=pol.cap_factor)


def step_for(kind: str, cfg: ArchConfig, opts: T.ModelOpts,
             pol: ArchPolicy) -> Callable:
    """The step a cell of ``kind`` runs for ``cfg``: the trainer's step,
    ``prefill`` or one ``decode_step``."""
    if kind == "train":
        oc = OptConfig(m_dtype=pol.m_dtype, v_dtype=pol.v_dtype,
                       factored_v=pol.factored_v)
        return make_train_step(cfg, oc, TrainConfig(grad_accum=pol.grad_accum),
                               opts=opts)
    if kind == "prefill":
        def step(params, cache, tokens, frontend=None):
            return T.prefill(params, cfg, tokens, cache, opts=opts,
                             frontend_embeds=frontend)
        return step

    def step(params, cache, tokens):
        return T.decode_step(params, cfg, cache, tokens, opts=opts)
    return step


def plan_cell(arch: str, shape_name: str, mesh,
              remat: str | None = None) -> CellPlan:
    """The cell's plan; ``remat`` replaces a train cell's remat policy
    ("full" by default, as the reference plans it)."""
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    pol = policy_for(arch)

    if shp.name == "long_500k" and not cfg.subquadratic:
        raise Skip(f"{arch} is pure full-attention: long_500k skipped per "
                   "assignment (DESIGN.md §6)")

    opts = model_opts(shape_name, pol)
    if remat is not None and shp.kind == "train":
        opts = dataclasses.replace(opts, remat=remat)
    if shp.kind == "train":
        return plan_train(cfg, mesh, batch=shp.global_batch,
                          seq=shp.seq_len, policy=pol, opts=opts,
                          shape_name=shape_name, arch=arch)
    kind = rules_kind(shape_name)
    rules = make_rules(cfg, mesh, kind=kind)
    ins = input_specs(arch, shape_name, mesh)
    params = param_structs(cfg, mesh, rules, pol.param_dtype)
    step = step_for(shp.kind, cfg, opts, pol)
    common = dict(cfg=cfg, rules=rules, opts=opts, policy=pol,
                  rules_kind=kind)
    if shp.kind == "prefill":
        args = [params, ins["cache"], ins["tokens"]]
        if "frontend" in ins:
            args.append(ins["frontend"])
        return CellPlan(arch, shape_name, "prefill", step, tuple(args),
                        **common)
    # decode: one new token against a seq_len-deep cache
    return CellPlan(arch, shape_name, "decode", step,
                    (params, ins["cache"], ins["tokens"]), note=kind,
                    **common)


def plan_train(cfg: ArchConfig, mesh, *, batch: int, seq: int,
               policy: ArchPolicy, opts: T.ModelOpts,
               shape_name: str = "custom", arch: str = "") -> CellPlan:
    """A train cell of any (batch, seq) under ``policy`` and ``opts``
    (``plan_cell``'s train branch; ``chip_smoke.py`` plans its own train
    step's cell with it)."""
    rules = make_rules(cfg, mesh, kind="train")
    params = param_structs(cfg, mesh, rules, policy.param_dtype)
    opt = opt_structs(cfg, mesh, rules, policy)
    ins = _inputs(cfg, "train", batch, seq, rules)
    return CellPlan(arch or cfg.name, shape_name, "train",
                    step_for("train", cfg, opts, policy), (params, opt, ins),
                    note=f"GA={policy.grad_accum} "
                         f"groups={policy.scan_groups}",
                    cfg=cfg, rules=rules, opts=opts, policy=policy,
                    rules_kind="train")


def all_cells():
    for arch in list_archs():
        for shape in SHAPES:
            yield arch, shape
