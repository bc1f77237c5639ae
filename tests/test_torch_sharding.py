"""The port's sharding rules and partition specs against the reference's:
``make_rules`` table for table on the production meshes (16 x 16 and
2 x 16 x 16, as the reference test's ``FakeMesh`` describes them), the
TP-only byte count and the parameter count, every parameter leaf's spec
(the reference's without its leading "layers" entry), and the twins of
tests/test_sharding_rules.py. Exact: these are integer tables."""
import jax
import pytest

from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.models import transformer as JT
from repro.models.params import count_params as j_count_params
from repro.models.params import is_spec as j_is_spec
from repro.models.params import pspec_of as j_pspec_of
from repro.models.sharding import _tp_only_bytes as j_tp_only_bytes
from repro.models.sharding import make_rules as j_make_rules
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (axis_sizes, make_mesh_for,
                                     make_production_mesh)
from repro_torch.models import transformer as T
from repro_torch.models.convert import STACKED
from repro_torch.models.params import (count_params, logical_pspec,
                                       param_pspecs, pspec_axes, pspec_of,
                                       spec_leaves, tree_paths_map)
from repro_torch.models.sharding import _tp_only_bytes, make_rules

KINDS = ["train", "prefill", "decode", "decode_long"]


class FakeMesh:
    """The reference test's mesh stand-in: axis names and devices.shape."""

    def __init__(self, multi_pod: bool):
        self.axis_names = (("pod", "data", "model") if multi_pod
                           else ("data", "model"))

        class _Dev:
            shape = (2, 16, 16) if multi_pod else (16, 16)
        self.devices = _Dev()


def _sizes():
    return {"pod": 2, "data": 16, "model": 16}


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_archs())
def test_rules_equal_reference(arch, kind, multi_pod):
    """Both tables, entry for entry and in order; the port's planning
    mesh gives the same rules as the stand-in."""
    mesh = FakeMesh(multi_pod)
    ref = j_make_rules(j_get_config(arch), mesh, kind=kind)
    mine = make_rules(get_config(arch), mesh, kind=kind)
    assert mine.acts.table == ref.acts.table
    assert mine.params.table == ref.params.table
    plan = make_rules(get_config(arch),
                      make_production_mesh(multi_pod=multi_pod), kind=kind)
    assert plan.acts.table == ref.acts.table
    assert plan.params.table == ref.params.table
    assert mine.lookup("batch") == ref.lookup("batch")


@pytest.mark.parametrize("arch", list_archs())
def test_tp_only_bytes_and_count_params_equal(arch):
    for m in (1, 2, 16):
        assert _tp_only_bytes(get_config(arch), m) == \
            j_tp_only_bytes(j_get_config(arch), m)
    assert count_params(T.model_spec(get_config(arch))) == \
        j_count_params(JT.model_spec(j_get_config(arch)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", list_archs())
def test_leaf_pspecs_are_the_references_without_layers(arch, kind):
    """Every port leaf's spec equals its reference leaf's, whose leading
    "layers" entry (None everywhere) is dropped for a stacked leaf."""
    mesh = FakeMesh(True)
    jrules = j_make_rules(j_get_config(arch), mesh, kind=kind)
    rules = make_rules(get_config(arch), mesh, kind=kind)
    mine = param_pspecs(T.model_spec(get_config(arch)), rules.params)
    flat = jax.tree_util.tree_flatten_with_path(
        JT.model_spec(j_get_config(arch)), is_leaf=j_is_spec)[0]
    n = 0
    for path, s in flat:
        keys = [k.key for k in path]
        want = tuple(j_pspec_of(s, jrules.params))
        if keys[0] in STACKED:
            assert s.names[0] == "layers" and jrules.params.lookup(
                "layers") is None
            want = want[1:]
            layers = mine[keys[0]]
            assert len(layers) == s.shape[0]
        else:
            layers = [mine]
        for tree in layers:
            got = tree
            for k in (keys[1:] if keys[0] in STACKED else keys):
                got = got[k]
            assert got == want, (keys, got, want)
            n += 1
    assert n == len(spec_leaves(T.model_spec(get_config(arch))))


# ---------------------------------------------------------------------------
# Twins of tests/test_sharding_rules.py
# ---------------------------------------------------------------------------
def _factor(entry, sizes):
    f = 1
    for a in pspec_axes(entry):
        f *= sizes[a]
    return f


@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("kind", KINDS)
def test_param_pspecs_divide_and_no_dup(arch, kind):
    cfg = get_config(arch)
    rules = make_rules(cfg, FakeMesh(True), kind=kind)
    sizes = _sizes()

    def check(s):
        ps = pspec_of(s, rules.params)
        used = []
        for dim, entry in zip(s.shape, ps + (None,) * len(s.shape)):
            used.extend(pspec_axes(entry))
            assert dim % _factor(entry, sizes) == 0, (arch, kind, s.shape,
                                                      ps)
        assert len(used) == len(set(used)), (arch, ps)
        return s
    tree_paths_map(check, T.model_spec(cfg))


@pytest.mark.parametrize("arch", ["gemma3-1b", "llama3-405b",
                                  "mixtral-8x7b", "mamba2-780m"])
def test_cache_pspecs_divide(arch):
    from repro_torch.launch.specs import cache_structs, planned_leaves
    cfg = get_config(arch)
    mesh = FakeMesh(True)
    for kind, batch, seq in [("decode", 128, 32768),
                             ("decode_long", 1, 524288)]:
        if kind == "decode_long" and not cfg.subquadratic:
            continue
        rules = make_rules(cfg, mesh, kind=kind)
        for p in planned_leaves(cache_structs(cfg, batch, seq, rules,
                                              enc_len=4096)):
            for dim, e in zip(p.shape, p.pspec):
                assert dim % _factor(e, _sizes()) == 0, (arch, kind, p)
            p.local_shape(mesh)        # raises unless every entry divides
        kv = logical_pspec(("batch", "seq", "kv_heads", "cache_hd"),
                           rules.acts)
        if kind == "decode":         # batch over the FSDP axes
            assert kv[0] == ("pod", "data")
        else:                        # one sequence cut over every axis
            assert kv[:2] == (None, ("pod", "data", "model"))


def test_serve_params_drop_fsdp_for_small_archs():
    mesh = FakeMesh(True)
    small = make_rules(get_config("gemma3-1b"), mesh, kind="decode")
    big = make_rules(get_config("llama3-405b"), mesh, kind="decode")
    # small model: replicated (TP-only) serve params on the embed axis
    assert small.params.lookup("embed") is None
    # 405B cannot fit TP-only: keeps FSDP sharding at serve time
    assert big.params.lookup("embed") is not None


def test_meshes_describe_their_axes():
    """The planning meshes and the mesh reader: names, sizes, device
    counts; a wrong device count raises."""
    single, multi = (make_production_mesh(multi_pod=m) for m in (0, 1))
    assert axis_sizes(single) == {"data": 16, "model": 16}
    assert axis_sizes(multi) == {"pod": 2, "data": 16, "model": 16}
    assert single.size == 256 and multi.size == 512
    assert axis_sizes(FakeMesh(True)) == axis_sizes(multi)

    class DeviceMeshLike:        # torch.distributed's DeviceMesh names
        mesh_dim_names = ("data", "model")
        shape = (4, 2)
    assert axis_sizes(DeviceMeshLike()) == {"data": 4, "model": 2}
    one = make_mesh_for(1, (1, 1), ("data", "model"))
    rules = make_rules(get_config("gemma3-1b"), one, kind="train")
    assert rules.params.lookup("embed") == ("data",)
    with pytest.raises(ValueError, match="devices"):
        make_mesh_for(4, (2, 1), ("data", "model"))
