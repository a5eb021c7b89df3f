"""The port's sharding specs, cell shapes and meshes against the JAX
package's, on the CPU.

  * the replays of ``tests/test_sharding.py`` (every arch at full size on
    both production layouts, the "> 64 MB is sharded" rule, the state and
    data specs over ``SHAPES``), of ``tests/test_launch.py``'s
    ``test_input_specs_cover_all_runnable_cells``,
    ``test_long500k_skips_are_exactly_the_full_attention_archs`` and
    ``test_mesh_factory_shapes``, and of
    ``tests/test_training.py::test_opt_specs_add_zero1_sharding``;
  * every port spec against the reference's, leaf by leaf, for all eleven
    archs on both layouts under each of the reference's three environment
    settings (set on the reference's side with ``monkeypatch.setenv``,
    passed as keywords on the port's): a port parameter spec is the
    reference's without the leading ``None`` of its layer-stack axis;
  * every cell's ``input_specs`` (meta tensors) against the reference's
    shapes and dtypes; the ZeRO-1 moment specs against the reference's off
    its layer-stack axis; ``to_placements`` and the host mesh.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import CONFIGS as JCONFIGS  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import input_specs as jinput_specs  # noqa: E402
from repro.distributed import sharding as jsh  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.training.optimizer import opt_specs as jopt_specs  # noqa: E402
from repro_torch.configs import ASSIGNED, CONFIGS, SHAPES, cell_is_runnable, get_config  # noqa: E402
from repro_torch.configs.shapes import input_specs  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import registry  # noqa: E402
from repro_torch.training.optimizer import opt_specs  # noqa: E402
from repro_torch.training.tree import tree_leaves  # noqa: E402

ARCHS = sorted(CONFIGS)
# the reference's three environment switches and the port's keywords
SETTINGS = {
    "default": ({}, {}, {}),
    "attn_replicate": ({"REPRO_ATTN_SHARDING": "replicate"}, {"attn_fallback": "replicate"},
                       {}),
    "kv_shard": ({"REPRO_ATTN_KV_SHARD": "1"}, {}, {"kv_shard": True}),
    "kv_cache_replicate": ({"REPRO_KV_CACHE_SHARDING": "replicate"}, {},
                           {"kv_cache_fallback": "replicate"}),
}


class FakeMesh:
    """Axis metadata stand-in (spec construction needs sizes, not devices)."""

    def __init__(self, multi_pod=False, data=16):
        shape, axes = mesh_mod.production_mesh_shape(multi_pod)
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))
        self.shape["data"] = data


def _axis_sizes(mesh, name_or_tuple):
    if name_or_tuple is None:
        return 1
    names = name_or_tuple if isinstance(name_or_tuple, tuple) else (name_or_tuple,)
    n = 1
    for a in names:
        n *= mesh.shape[a]
    return n


def _assert_legal(spec_tree, shape_tree, mesh):
    specs, leaves = tree_leaves(spec_tree), tree_leaves(shape_tree)
    assert len(specs) == len(leaves)
    for spec, leaf in zip(specs, leaves):
        assert isinstance(spec, sh.PartitionSpec)
        assert len(spec) <= len(leaf.shape), (spec, leaf.shape)
        for axis_name, dim in zip(spec, leaf.shape):
            if axis_name is None:
                continue
            n = _axis_sizes(mesh, axis_name)
            assert dim % n == 0, f"dim {dim} not divisible by {axis_name}={n}"


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    """The port's full-size parameter tree on ``meta``."""
    cfg = get_config(arch)
    return registry.get_model(cfg).init(cfg, device="meta")


@functools.lru_cache(maxsize=None)
def _jshapes(arch):
    cfg = JCONFIGS[arch]
    return jax.eval_shape(lambda k: jregistry.get_model(cfg).init(k, cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


@functools.lru_cache(maxsize=None)
def _jcell(arch, shape_name):
    return jinput_specs(JCONFIGS[arch], JSHAPES[shape_name])


def _is_jp(x):
    return isinstance(x, JP)


def _tuples(tree, strip=False):
    """A reference spec tree as tuples (the leading layer-stack entry
    dropped with ``strip``)."""
    return jax.tree_util.tree_map(lambda s: tuple(s)[1:] if strip else tuple(s), tree,
                                  is_leaf=_is_jp)


def _unstacked(cfg, ref, strip=True):
    """The reference's parameter spec tree in the port's per-layer layout
    (``models.convert``'s unstacking), each stacked leaf's layer-stack
    entry dropped unless ``strip`` is false."""
    if cfg.family == "encdec":
        return {"embed": _tuples(ref["embed"]), "dec_pos": tuple(ref["dec_pos"]),
                "encoder": [_tuples(ref["encoder"], strip)] * cfg.n_encoder_layers,
                "enc_norm": _tuples(ref["enc_norm"]),
                "decoder": [_tuples(ref["decoder"], strip)] * cfg.n_layers,
                "dec_norm": _tuples(ref["dec_norm"])}
    period = len(ref["layers"])
    return {"embed": _tuples(ref["embed"]),
            "layers": [_tuples(ref["layers"][i % period], strip) for i in range(cfg.n_layers)],
            "final_norm": _tuples(ref["final_norm"])}


def _spec_leaves(tree):
    """The specs of a tree of dicts and lists, in the port's leaf order
    (a spec, a tuple here, is one leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _spec_leaves(v)]
    return [tree]


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree)


# --------------------------------------------------------------------------- #
# Replays of tests/test_sharding.py
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("multi_pod", [False, True])
def test_param_specs_legal_full_size(arch, multi_pod):
    cfg = get_config(arch)
    mesh = FakeMesh(multi_pod)
    _assert_legal(sh.param_specs(cfg, _shapes(arch), mesh), _shapes(arch), mesh)


@pytest.mark.parametrize("arch", ARCHS)
def test_big_tensors_are_sharded(arch):
    """No parameter tensor above 64 MB (bf16) is fully replicated on the
    256-chip mesh: the tensor-parallel and FSDP rules fire."""
    specs = sh.param_specs(get_config(arch), _shapes(arch), FakeMesh())
    for spec, leaf in zip(tree_leaves(specs), tree_leaves(_shapes(arch))):
        nbytes = int(np.prod(leaf.shape)) * 2
        if nbytes > 64 * 2**20:
            assert any(a is not None for a in spec), (
                f"{arch}: {tuple(leaf.shape)} ({nbytes / 2**20:.0f} MB) replicated")


CELLS = [(a, s) for a in ARCHS for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape_name", [c for c in CELLS if c[0] != "llama-7b"])
def test_state_and_data_specs_legal(arch, shape_name):
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if not cell_is_runnable(cfg, shape)[0]:  # the documented long_500k skip
        with pytest.raises(ValueError, match="is skipped"):
            input_specs(cfg, shape)
        return
    cell = input_specs(cfg, shape)
    mesh = FakeMesh(multi_pod=True)
    _assert_legal(sh.data_specs(cfg, cell.batch, shape.global_batch, mesh), cell.batch, mesh)


# --------------------------------------------------------------------------- #
# Every spec against the reference's
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_reference(arch, multi_pod, setting, monkeypatch):
    env, param_kw, state_kw = SETTINGS[setting]
    for name in ("REPRO_ATTN_SHARDING", "REPRO_ATTN_KV_SHARD", "REPRO_KV_CACHE_SHARDING"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    cfg, jcfg, mesh = get_config(arch), JCONFIGS[arch], FakeMesh(multi_pod)
    want = _unstacked(cfg, jsh.param_specs(jcfg, _jshapes(arch), mesh))
    assert _as_tuples(sh.param_specs(cfg, _shapes(arch), mesh, **param_kw)) == want
    for shape_name, shape in SHAPES.items():
        if not cell_is_runnable(cfg, shape)[0]:
            continue
        jcell, cell = _jcell(arch, shape_name), input_specs(cfg, shape)
        got = sh.data_specs(cfg, cell.batch, shape.global_batch, mesh, **state_kw)
        jwant = jsh.data_specs(jcfg, jcell.batch, shape.global_batch, mesh)
        got_leaves = [tuple(s) for s in tree_leaves(got)]
        want_leaves = [tuple(s) for s in jax.tree_util.tree_leaves(jwant, is_leaf=_is_jp)]
        assert got_leaves == want_leaves, (arch, shape_name)
        assert sorted(got) == sorted(jwant)


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(arch, shape_name):
    """Each cell's batch: the reference's keys, and leaf for leaf its
    shapes and dtypes, as ``meta`` tensors (nothing allocated)."""
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if not cell_is_runnable(cfg, shape)[0]:
        with pytest.raises(ValueError):
            input_specs(cfg, shape)
        with pytest.raises(ValueError):
            jinput_specs(JCONFIGS[arch], JSHAPES[shape_name])
        return
    cell, jcell = input_specs(cfg, shape), _jcell(arch, shape_name)
    assert (cell.arch, cell.shape, cell.kind) == (jcell.arch, jcell.shape, jcell.kind)
    assert sorted(cell.batch) == sorted(jcell.batch)
    got = tree_leaves(cell.batch)
    want = jax.tree_util.tree_leaves(jcell.batch)
    assert [(tuple(t.shape), str(t.dtype).replace("torch.", "")) for t in got] == [
        (tuple(s.shape), str(s.dtype)) for s in want]
    assert all(t.device.type == "meta" for t in got)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_match_reference_off_the_layer_axis(arch):
    """The ZeRO-1 rule on the port's per-layer moments: where the
    reference's rule puts ``data`` on a dim other than its layer-stack axis,
    the port's spec is the reference's without that axis; where it puts it
    on the stack axis, which the port's per-layer leaf lacks, the port's
    rule puts it on the leaf's largest unsharded dim that ``data`` divides,
    if any."""
    cfg, jcfg, mesh = get_config(arch), JCONFIGS[arch], FakeMesh()
    jspecs = jsh.param_specs(jcfg, _jshapes(arch), mesh)
    want = _spec_leaves(_unstacked(cfg, jopt_specs(jspecs, _jshapes(arch), mesh).m,
                                   strip=False))
    before = _spec_leaves(_as_tuples(sh.param_specs(cfg, _shapes(arch), mesh)))
    got = opt_specs(sh.param_specs(cfg, _shapes(arch), mesh), _shapes(arch), mesh)
    leaves = tree_leaves(_shapes(arch))
    assert len(want) == len(before) == len(leaves)
    on_stack = 0
    for g, w, b, leaf in zip(_spec_leaves(_as_tuples(got.m)), want, before, leaves):
        if len(w) == len(g) + 1 and w[0] == "data":
            on_stack += 1
            assert w[1:] == b
            free = [i for i, e in enumerate(b) if e is None and leaf.shape[i] % 16 == 0]
            best = max(free, key=lambda i: (leaf.shape[i], -i)) if free else None
            assert g == tuple("data" if i == best else e for i, e in enumerate(b)), (g, b)
        else:
            assert g == (w[1:] if len(w) == len(g) + 1 else w)
    assert got.step == sh.P()
    assert on_stack < len(want)


# --------------------------------------------------------------------------- #
# Replays of tests/test_launch.py and tests/test_training.py
# --------------------------------------------------------------------------- #
def test_mesh_factory_shapes():
    """The production layouts: one pod (data 16, model 16), two pods (pod
    2, data 16, model 16)."""
    assert mesh_mod.production_mesh_shape(False) == ((16, 16), ("data", "model"))
    assert mesh_mod.production_mesh_shape(True) == ((2, 16, 16), ("pod", "data", "model"))


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_input_specs_cover_all_runnable_cells(arch):
    cfg = ASSIGNED[arch]
    for shape in SHAPES.values():
        ok, why = cell_is_runnable(cfg, shape)
        if not ok:
            assert shape.name == "long_500k" and not cfg.supports_long_context
            continue
        cell = input_specs(cfg, shape)
        leaves = tree_leaves(cell.batch)
        assert leaves and all(isinstance(t, torch.Tensor) and t.is_meta for t in leaves)
        # the batch dim is the assigned global batch everywhere it appears
        if "tokens" in cell.batch:
            assert cell.batch["tokens"].shape[0] == shape.global_batch


def test_long500k_skips_are_exactly_the_full_attention_archs():
    skipped = {a for a, c in ASSIGNED.items() if not cell_is_runnable(c, SHAPES["long_500k"])[0]}
    assert skipped == {
        "granite-34b", "mistral-nemo-12b", "qwen2-1.5b", "qwen2-0.5b",
        "whisper-tiny", "internvl2-1b", "olmoe-1b-7b",
    }


def test_registry_splits_as_the_reference():
    from repro.configs import ASSIGNED as JASSIGNED, EXTRA as JEXTRA
    from repro_torch.configs import EXTRA

    assert list(ASSIGNED) == list(JASSIGNED) and list(EXTRA) == list(JEXTRA)
    assert {n: (s.kind, s.seq_len, s.global_batch) for n, s in SHAPES.items()} == {
        n: (s.kind, s.seq_len, s.global_batch) for n, s in JSHAPES.items()}


def test_opt_specs_add_zero1_sharding():
    """For pure-DP archs, moments gain a data-axis dim; specs stay legal
    (every sharded dim divisible by the axis)."""
    cfg = get_config("qwen2-1.5b")  # dp arch, full size
    mesh = FakeMesh()
    specs = sh.param_specs(cfg, _shapes("qwen2-1.5b"), mesh)
    ospecs = opt_specs(specs, _shapes("qwen2-1.5b"), mesh)
    for spec, leaf in zip(tree_leaves(ospecs.m), tree_leaves(_shapes("qwen2-1.5b"))):
        for name, dim in zip(spec, leaf.shape):
            if name in ("data", "model"):
                assert dim % 16 == 0
    n_sharded = sum("data" in spec for spec in tree_leaves(ospecs.m))
    assert n_sharded > 0
    assert ospecs.m is ospecs.v


# --------------------------------------------------------------------------- #
# The spec type, placements, meta init and the host mesh
# --------------------------------------------------------------------------- #
def test_partition_spec_is_an_immutable_leaf():
    spec = sh.P(None, "model", ("pod", "data"))
    assert spec == (None, "model", ("pod", "data")) == sh.P(None, "model", ("pod", "data"))
    assert len(spec) == 3 and spec[1] == "model" and list(spec)[2] == ("pod", "data")
    assert hash(spec) == hash(sh.P(None, "model", ("pod", "data")))
    with pytest.raises(AttributeError):
        spec.x = 1
    assert tree_leaves({"a": spec, "b": [sh.P()]}) == [spec, sh.P()]
    with pytest.raises(ValueError):
        sh.param_specs(get_config("qwen2-0.5b"), _shapes("qwen2-0.5b"), FakeMesh(),
                       attn_fallback="heads")


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-1.3b", "whisper-tiny", "olmoe-1b-7b"])
def test_meta_init_has_the_cpu_tree(arch):
    """``init(cfg, device="meta")`` gives the CPU init's tree, shapes and
    dtypes, with nothing drawn."""
    from repro_torch.configs import reduced_config

    cfg = reduced_config(get_config(arch))
    api = registry.get_model(cfg)
    meta, cpu = api.init(cfg, device="meta"), api.init(cfg, seed=0, device="cpu")
    got, want = tree_leaves(meta), tree_leaves(cpu)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype) for t in want]
    assert all(t.is_meta for t in got)
    assert sum(t.numel() for t in tree_leaves(_shapes(arch))) == get_config(arch).param_count()


def test_host_mesh_and_placements():
    """``host_mesh`` on the CPU starts a single-rank gloo group, gives a
    (data, model) ``DeviceMesh`` and destroys the group after; specs become
    DTensor placements; a mesh the world does not fill, or a CUDA mesh on
    a gloo group, raises."""
    from torch.distributed.tensor import Replicate, Shard

    assert not torch.distributed.is_initialized()
    with mesh_mod.host_mesh(1, 1, device="cpu") as mesh:
        assert torch.distributed.get_backend() == "gloo"
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        assert sh.mesh_axes(mesh) == {"data": 1, "model": 1}
        assert sh.batch_axes(mesh) == ("data",)
        assert sh.to_placements(sh.P(None, "model", "data"), mesh) == (Shard(2), Shard(1))
        assert sh.to_placements(sh.P(("data", "model"), None), mesh) == (Shard(0), Shard(0))
        assert sh.to_placements(sh.P(None, None), mesh) == (Replicate(), Replicate())
        with pytest.raises(ValueError, match="world size"):
            mesh_mod.make_host_mesh(2, 1, device="cpu")
        with pytest.raises(RuntimeError, match="nccl"):
            mesh_mod.make_host_mesh(1, 1, device="cuda")
    assert not torch.distributed.is_initialized()
