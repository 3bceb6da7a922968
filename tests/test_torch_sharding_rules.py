"""The port's partition rules (``repro_torch.sharding.rules``) held exactly
to the reference's (``repro.sharding.rules``), device-free.

For every registered arch at full width and five mesh shapes — the
production (16, 16) and (2, 16, 16), and (4, 4), (2, 2), (1, 1) — the
port's spec for every leaf equals the reference's ``tuple(PartitionSpec)``
and its path string the reference's: the abstract params in train and
decode modes (on torch's ``meta`` device and under ``jax.eval_shape``),
their AdamW state, a train batch with and without the pod axis over the
batch, and the decode cache at ``decode_32k``.  The reference's specs come
from its own functions on a ``jax.sharding.AbstractMesh`` (its
``NamedSharding`` needs a mesh object; no devices are touched); the port's
from a plain object with ``.shape`` and ``.axis_names``, as the
reference's tests' ``FakeMesh``.  Then the reference's own rule cases
(``tests/test_sharding_rules.py``) as parametrised cases, the placements
a spec gives on a ``DeviceMesh``, the local shard shapes, the
constraints' no-op without a mesh, and the refusals: a tensor placed on
a mesh of another device type, a host mesh without one, a ``SplitLink``
at the cut over a mesh."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import base as jconfigs  # noqa: E402
from repro.data import pipeline as jpipeline  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import base as tconfigs  # noqa: E402
from repro_torch.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.data import pipeline as tpipeline  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import stack as tstack  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.sharding import constraints, rules  # noqa: E402


class FakeMesh:
    """Minimal stand-in exposing .shape / .axis_names (no devices needed)."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "4x4": {"data": 4, "model": 4},
          "2x2": {"data": 2, "model": 2},
          "1x1": {"data": 1, "model": 1}}
TREES = ["params-train", "params-decode", "opt_state", "batch", "batch-no-pod",
         "cache"]
TRAIN, DECODE = "train_4k", "decode_32k"


def _abstract(shape: dict) -> AbstractMesh:
    return AbstractMesh(tuple(shape.values()), tuple(shape))


def _jflat(tree) -> dict:
    """{path string: spec tuple} of a reference NamedSharding tree, by the
    reference's own ``_path_str``."""
    leaves = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {jrules._path_str(p): tuple(s.spec) for p, s in leaves}


def _tflat(specs, like) -> dict:
    """{path string: spec} of a port spec tree, walked by ``like`` (the
    tensor tree the specs were made from), with the port's ``_path_str``."""
    out = {}
    rules.tree_map_with_path(
        lambda path, _: out.__setitem__(rules._path_str(path), _lookup(specs, path)),
        like)
    return out


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@functools.lru_cache(maxsize=None)
def _trees(arch: str):
    """(reference abstract trees, port meta trees) of ``arch`` at full width."""
    jcfg, tcfg = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jp = jax.eval_shape(lambda: jlm.init_lm_params(jax.random.PRNGKey(0), jcfg))
    tp = tlm.abstract_params(tcfg, torch.bfloat16)
    spec = tpipeline.SHAPES[DECODE]
    j = {"params": jp, "opt_state": jax.eval_shape(jadamw(1e-4).init, jp),
         "batch": jpipeline.input_specs(jcfg, TRAIN),
         "cache": jlm.abstract_decode_cache(jcfg, spec["global_batch"],
                                            spec["seq_len"], jnp.bfloat16)}
    t = {"params": tp, "opt_state": tadamw(1e-4).init(tp),
         "batch": tpipeline.input_specs(tcfg, TRAIN),
         "cache": tlm.abstract_decode_cache(tcfg, spec["global_batch"],
                                            spec["seq_len"], torch.bfloat16)}
    return j, t


def _specs(arch: str, mesh_name: str, tree: str):
    """(reference {path: spec}, port {path: spec}) of one tree."""
    j, t = _trees(arch)
    am, fm = _abstract(MESHES[mesh_name]), FakeMesh(MESHES[mesh_name])
    if tree.startswith("params"):
        mode = tree.split("-")[1]
        return (_jflat(jrules.param_shardings(j["params"], am, mode=mode)),
                _tflat(rules.param_shardings(t["params"], fm, mode=mode), t["params"]))
    if tree == "opt_state":
        return (_jflat(jrules.opt_state_shardings(j["opt_state"], am)),
                _tflat(rules.opt_state_shardings(t["opt_state"], fm), t["opt_state"]))
    if tree.startswith("batch"):
        pod = tree == "batch"
        js = jax.tree.map(lambda s: tuple(s.spec),
                          jrules.batch_shardings(j["batch"], am, pod),
                          is_leaf=lambda x: hasattr(x, "spec"))
        return ({f"/{k}": v for k, v in js.items()},
                _tflat(rules.batch_shardings(t["batch"], fm, pod), t["batch"]))
    return (_jflat(jrules.cache_shardings(j["cache"], am)),
            _tflat(rules.cache_shardings(t["cache"], fm), t["cache"]))


@pytest.mark.parametrize("tree", TREES)
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_equal_the_references(arch, mesh_name, tree):
    want, got = _specs(arch, mesh_name, tree)
    assert want and got == want


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_path_strings_equal_the_references(arch):
    """Every leaf's path string, in the reference's order, from the
    reference's jax key paths and from the port's nested dicts."""
    j, t = _trees(arch)
    for name in ("params", "opt_state", "cache"):
        want = [jrules._path_str(p) for p, _ in
                jax.tree_util.tree_leaves_with_path(j[name])]
        got = []
        rules.tree_map_with_path(lambda p, _: got.append(rules._path_str(p)),
                                 t[name])
        assert got == want, name


# --- the reference's own rule cases ------------------------------------------

MESH = FakeMesh({"data": 16, "model": 16})
SPEC_CASES = [
    # attention weights; a stacked leading superblock dim padded with None
    ("/stack/l0_0_attn/w_q", (4096, 4096), P(None, "model")),
    ("/stack/l0_0_attn/w_o", (4096, 4096), P("model", None)),
    ("/stack/l0_0_attn/w_q", (30, 4096, 4096), P(None, None, "model")),
    # MoE expert parallelism; the router replicated (its output feeds top_k)
    ("/stack/l0_1_moe/w_gate", (16, 4096, 6400), P("model", None, None)),
    ("/stack/l0_1_moe/router", (4096, 16), P(None, None)),
    # divisibility guard: 10 heads not divisible by 16 -> replicate
    ("/x/w_q", (4096, 10), P(None, None)),
    ("/x/w_k", (4096, 256), P(None, "model")),
    # rwkv channel-mix w_v is an OUTPUT projection: row-sharded
    ("/stack/l0_1_rwkv_cm/w_v", (7168, 2048), P("model", None)),
    ("/stack/l0_0_attn/w_v", (2048, 2048), P(None, "model")),
    # norms replicated
    ("/stack/l0_0_attn/norm/scale", (4096,), P(None)),
    ("/final_norm/scale", (4096,), P(None)),
]
EXTEND_CASES = [
    # the largest free dim; already fully sharded; nothing divisible
    (P(None, "model"), (4096, 4096), P("data", "model")),
    (P("data", "model"), (4096, 4096), P("data", "model")),
    (P(), (5, 3), P(None, None)),
]
GUARD_CASES = [
    (P("model", None), (4096, 4096)),
    (P(("pod", "data"), None), (64, 8)),
    (P("data", "model"), (8, 24)),          # 8 < 16: the size guard
    (P("model",), (15,)),
]


@pytest.mark.parametrize("path,shape,want", SPEC_CASES)
def test_spec_for_param_cases(path, shape, want):
    got = rules.spec_for_param(path, shape, MESH)
    assert got == tuple(want) == tuple(jrules.spec_for_param(path, shape, MESH))


@pytest.mark.parametrize("spec,shape,want", EXTEND_CASES)
def test_extend_over_cases(spec, shape, want):
    got = rules._extend_over(tuple(spec), shape, MESH, "data")
    assert got == tuple(want) == tuple(jrules._extend_over(spec, shape, MESH, "data"))


@pytest.mark.parametrize("spec,shape", GUARD_CASES)
def test_guard_cases(spec, shape):
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert rules._guard(tuple(spec), shape, mesh) == tuple(
        jrules._guard(spec, shape, mesh))


def test_cache_rule_case():
    """(N, B, T, KV, hd): B over data, T over model (size-1 axes always
    divide), as the reference's host-mesh case."""
    cache = {"stack": {"l0_0_attn": {"k": np.zeros((2, 4, 8, 2, 16)),
                                     "v": np.zeros((2, 4, 8, 2, 16))}}}
    got = rules.cache_shardings(cache, mesh_lib.mesh_shape(1, 1))
    assert got["stack"]["l0_0_attn"]["k"] == (None, "data", "model", None, None)


# --- meshes, placements, shards ----------------------------------------------

def test_mesh_shapes():
    single, multi = (mesh_lib.make_production_mesh(multi_pod=m) for m in (False, True))
    assert (single.shape, single.axis_names, single.size) == (
        {"data": 16, "model": 16}, ("data", "model"), 256)
    assert (multi.shape, multi.axis_names, multi.size) == (
        {"pod": 2, "data": 16, "model": 16}, ("pod", "data", "model"), 512)
    assert mesh_lib.mesh_shape(4, 1).shape == {"data": 4, "model": 1}


class _Mesh:
    """What ``placements`` reads of a ``DeviceMesh``."""
    def __init__(self, *names):
        self.mesh_dim_names = names


@pytest.mark.parametrize("spec,names,want", [
    ((None, "model"), ("data", "model"), ("R", "S1")),
    (("model", "data"), ("data", "model"), ("S1", "S0")),
    ((("pod", "data"), None, "model"), ("pod", "data", "model"), ("S0", "S0", "S2")),
    ((), ("data", "model"), ("R", "R")),
])
def test_placements(spec, names, want):
    from torch.distributed.tensor import Replicate, Shard
    name = {Replicate(): "R"}
    got = rules.placements(spec, _Mesh(*names))
    assert tuple(name.get(p, f"S{getattr(p, 'dim', '?')}") for p in got) == want
    assert all(isinstance(p, (Replicate, Shard)) for p in got)


def test_placements_refuse_minor_to_major():
    with pytest.raises(ValueError, match="order"):
        rules.placements(((("data", "pod")),), _Mesh("pod", "data", "model"))


def test_local_shape():
    mesh = mesh_lib.mesh_shape(16, 16, 2)
    assert rules.local_shape((30, 4096, 11008), (None, "data", "model"), mesh) \
        == (30, 256, 688)
    assert rules.local_shape((256, 4096), (("pod", "data"), None), mesh) == (8, 4096)
    assert rules.local_shape((7,), (), mesh) == (7,)


def test_constraints_without_a_mesh_are_bitwise_no_ops():
    """No active mesh, or a plain tensor under one: the same tensor back."""
    h = torch.randn(4, 8, 16)
    assert constraints.constrain(h, ("data", "model", None)) is h
    assert tstack._activation_constraint(h) is h
    assert constraints.unshard(h, "model") is h
    with mesh_lib.set_mesh(mesh_lib.mesh_shape(2, 2)):
        assert mesh_lib.active_mesh().shape == {"data": 2, "model": 2}
        assert constraints.constrain(h, ("data", "model", None)) is h
        assert tstack._activation_constraint(h) is h
    assert mesh_lib.active_mesh() is None


def test_lm_loss_unchanged_under_an_inactive_mesh():
    """``lm_loss`` on plain tensors is bitwise the same with a mesh shape
    set active (the constraints see no DTensor) as without."""
    cfg = tconfigs.reduced(tconfigs.get_config("deepseek-7b"))
    params = tlm.init_lm_params(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 8)))
             for k in ("tokens", "labels")}
    want = tlm.lm_loss(params, batch, cfg)
    with mesh_lib.set_mesh(mesh_lib.mesh_shape(2, 2)):
        got = tlm.lm_loss(params, batch, cfg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_distribute_tree_refuses_another_device_type(device):
    """A tensor on another device type than the mesh's raises before
    ``distribute_tensor`` could move it there."""
    mesh = _Mesh("data", "model")
    mesh.device_type = "cuda"
    with pytest.raises(ValueError, match=f"a {device} tensor placed on a cuda mesh"):
        rules.distribute_tree({"w": torch.zeros(4, device=device)},
                              {"w": ("data",)}, mesh)


def test_make_host_mesh_needs_a_device_type():
    with pytest.raises(TypeError, match="device_type"):
        mesh_lib.make_host_mesh(2, 2)


def test_cut_on_a_mesh_refuses_a_split_link():
    """The cut over a mesh runs a bare codec on each rank's rows; a
    ``SplitLink`` (its gradient channel groups rows of its own) raises."""
    from repro_torch import transport
    link = transport.build_link("c3sl:R=4 >> bwd:c3sl:R=2", D=64)
    with pytest.raises(ValueError, match="SplitLink"):
        tlm._roundtrip_on_mesh(link, None, torch.zeros(8, 64), False, None, None)
