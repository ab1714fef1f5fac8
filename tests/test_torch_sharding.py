"""The port's sharding rules, production meshes and train-state specs
against the JAX package's (``repro_torch.launch.sharding`` / ``.mesh`` /
``.train.train_state_specs`` against ``repro.launch``'s), at full width
on shape-only trees: no card, no compile.

- every case of ``tests/test_sharding_rules.py`` on the port's trees;
- ``param_pspec`` leaf by leaf against the reference's for every LM
  architecture, unstacked and with learner axes ``("data",)`` and
  ``("pod", "data")``: port layer i against the reference leaf
  ``convert._layers`` maps it to, the reference's repeat dim dropped;
- ``cache_pspec`` the same way at ``decode_32k`` and ``long_500k``;
- ``per_device_bytes`` against the bytes the reference's own specs and
  partition specs give on the same mesh shape;
- ``train_state_specs`` against the reference's ``jax.eval_shape`` tree
  at m 16, one architecture per family.

``paper_kernel`` is in the registry but is no LM (its config is the
kernel learner's): the LM architectures are ``all_arch_ids()``.
"""
import functools
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import get as jget
from repro.launch import sharding as jshd
from repro.launch import specs as jspecs
from repro.launch.train import train_state_specs as jtrain_state_specs
from repro.optim import OptimizerConfig as JOptimizerConfig

from repro_torch import convert
from repro_torch.configs import all_arch_ids, get as tget
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as shd
from repro_torch.launch import specs as tspecs
from repro_torch.launch.train import train_state_specs
from repro_torch.optim import OptimizerConfig

ARCHS = all_arch_ids()
# one architecture per family (MLA beside the dense one)
FAMILY_ARCHS = ("qwen2_5_3b", "olmoe_1b_7b", "mamba2_130m",
                "recurrentgemma_9b", "qwen2_vl_2b", "whisper_large_v3",
                "minicpm3_4b")
LEARNER_AXES = (None, ("data",), ("pod", "data"))
MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


# ---------------------------------------------------------------------------
# Trees, shared across the cases
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    return jspecs.param_specs(jget(arch))


@functools.lru_cache(maxsize=None)
def _tparams(arch):
    return tspecs.param_specs(tget(arch))


@functools.lru_cache(maxsize=None)
def _jcaches(arch, shape):
    return jspecs.input_specs(jget(arch), shape)["caches"]


@functools.lru_cache(maxsize=None)
def _tcaches(arch, shape):
    return tspecs.input_specs(tget(arch), shape)["caches"]


def _jkey(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _jflat(tree) -> dict:
    """The reference's leaves (or partition specs) by path."""
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))
    return {"/".join(_jkey(k) for k in path): leaf for path, leaf in flat}


def _tflat(tree, path=()) -> dict:
    """The port's tensors (or PSpecs) by path."""
    if torch.is_tensor(tree) or isinstance(tree, shd.PSpec):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    else:
        items = enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_tflat(v, path + (str(k),)))
    return out


def _param_map(arch):
    """port path prefix -> reference path prefix of the stacked units:
    ``layers/i`` -> ``stages/s/b<j>`` (``convert._layers``), an
    encoder-decoder's ``enc_blocks/i`` / ``dec_blocks/i`` -> the
    reference's vmapped stack."""
    cfg = tget(arch)
    if cfg.is_encdec:
        return {f"{k}/{i}": k for k, n in (
            ("enc_blocks", cfg.encoder_layers), ("dec_blocks", cfg.n_layers))
            for i in range(n)}
    return {f"layers/{i}": f"stages/{s}/b{j}" for i, (s, _, j, _) in
            enumerate(convert._layers(cfg, _jparams(arch)["stages"]))}


def _cache_map(arch):
    """The same for the caches: layer i -> ``<s>/b<j>``, or the
    encoder-decoder's stack (the root)."""
    cfg = tget(arch)
    if cfg.is_encdec:
        return {str(i): "" for i in range(cfg.n_layers)}
    return {str(i): f"{s}/b{j}" for i, (s, _, j, _) in
            enumerate(convert._layers(cfg, _jcaches(arch, "decode_32k")))}


def _ref_path(path, prefixes):
    """(reference path, whether it drops a stacked dim) of a port path."""
    parts = path.split("/")
    for n in (2, 1):
        head = "/".join(parts[:n])
        if head in prefixes:
            ref = prefixes[head]
            rest = "/".join(parts[n:])
            return (f"{ref}/{rest}" if ref else rest), True
    return path, False


def _drop(seq, at):
    seq = tuple(seq)
    return seq[:at] + seq[at + 1:]


def _assert_same_specs(tspecs_, jspecs_, ttree, jtree, prefixes, lead):
    """Every port leaf's spec equals its reference leaf's, the stacked
    dim (after ``lead`` learner dims) dropped; the shapes likewise."""
    tflat, jflat = _tflat(tspecs_), _jflat(jspecs_)
    tleaves, jleaves = _tflat(ttree), _jflat(jtree)
    assert set(tflat) == set(tleaves)
    seen = set()
    for path, spec in tflat.items():
        ref, stacked = _ref_path(path, prefixes)
        want, jl = tuple(jflat[ref]), jleaves[ref]
        jshape = tuple(jl.shape)
        if stacked:
            want, jshape = _drop(want, lead), _drop(jshape, lead)
        assert tuple(tleaves[path].shape) == jshape, path
        assert tuple(spec) == want, (path, spec, want)
        seen.add(ref)
    assert seen == set(jflat)


def _jstack(tree, m):
    return jax.tree.map(
        lambda l: jax.ShapeDtypeStruct((m,) + tuple(l.shape), l.dtype), tree)


# ---------------------------------------------------------------------------
# tests/test_sharding_rules.py's cases on the port's trees
# ---------------------------------------------------------------------------


def test_dense_param_rules():
    ps = shd.param_pspec(_tparams("granite_8b"), model_size=16)
    layer = ps["layers"][0]
    assert layer["attn"]["wq"]["w"] == shd.PSpec(None, "model")
    assert layer["attn"]["wo"]["w"] == shd.PSpec("model", None)
    assert layer["mlp"]["wi"]["w"] == shd.PSpec(None, "model")
    assert layer["mlp"]["wo"]["w"] == shd.PSpec("model", None)
    assert ps["embed"]["table"] == shd.PSpec("model", None)
    assert ps["lm_head"]["w"] == shd.PSpec(None, "model")
    # norm scales replicated
    assert layer["norm1"]["scale"] == shd.PSpec(None)


def test_moe_expert_parallel_rule():
    ps = shd.param_pspec(_tparams("olmoe_1b_7b"), model_size=16)
    layer = ps["layers"][0]
    assert layer["moe"]["wi"] == shd.PSpec("model", None, None)
    assert layer["moe"]["wo"] == shd.PSpec("model", None, None)
    assert layer["moe"]["router"]["w"] == shd.PSpec(None, None)


def test_nondivisible_dims_replicated():
    ps = shd.param_pspec(_tparams("mamba2_130m"), model_size=16)
    layer = ps["layers"][0]
    # in_proj out-dim (mixed concat 3352) not divisible -> replicated
    assert layer["ssm"]["in_proj"]["w"] == shd.PSpec(None, None)
    # out_proj in-dim 1536 divisible -> sharded
    assert layer["ssm"]["out_proj"]["w"] == shd.PSpec("model", None)


def test_learner_axis_prepended():
    stacked = tspecs.stacked_param_specs(tget("qwen2_5_3b"), 16)
    ps = shd.param_pspec(stacked, model_size=16, learner_axes=("data",))
    assert ps["layers"][0]["attn"]["wq"]["w"] == \
        shd.PSpec("data", None, "model")
    assert ps["embed"]["table"] == shd.PSpec("data", "model", None)


def test_multipod_learner_axes():
    stacked = tspecs.stacked_param_specs(tget("qwen2_5_3b"), 32)
    ps = shd.param_pspec(stacked, model_size=16,
                         learner_axes=("pod", "data"))
    assert ps["embed"]["table"] == shd.PSpec(("pod", "data"), "model", None)


def test_cache_pspec_shards_batch_and_length():
    cs = tspecs.cache_specs(tget("granite_8b"), B=128, length=32768)
    ps = shd.cache_pspec(cs, ("data",), batch=128, n_batch_axes_size=16,
                         model_size=16)
    assert ps[0].k == shd.PSpec("data", "model", None, None)


def test_cache_pspec_small_batch_replicated():
    cs = tspecs.cache_specs(tget("granite_8b").with_(window=4096), B=1,
                            length=4096)
    ps = shd.cache_pspec(cs, ("data",), batch=1, n_batch_axes_size=16,
                         model_size=16)
    assert ps[0].k == shd.PSpec(None, "model", None, None)


def test_stream_pspec_learner_dim():
    assert shd.stream_pspec(("learners",)) == shd.PSpec(None, "learners")
    assert shd.stream_pspec(("pod", "data")) == \
        shd.PSpec(None, ("pod", "data"))
    assert tuple(shd.stream_pspec(("pod", "data"))) == \
        tuple(jshd.stream_pspec(("pod", "data")))


# ---------------------------------------------------------------------------
# Leaf by leaf against the reference at full width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("learner_axes", LEARNER_AXES,
                         ids=["unstacked", "data", "pod_data"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_matches_reference(arch, learner_axes):
    ttree, jtree = _tparams(arch), _jparams(arch)
    if learner_axes:
        m = 16 * (2 if len(learner_axes) > 1 else 1)
        ttree = tspecs.stacked_param_specs(tget(arch), m)
        jtree = _jstack(jtree, m)
    got = shd.param_pspec(ttree, 16, learner_axes)
    want = jshd.param_pspec(jtree, 16, learner_axes)
    _assert_same_specs(got, want, ttree, jtree, _param_map(arch),
                       1 if learner_axes else 0)


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_pspec_matches_reference(arch, shape, multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    daxes, nd = tmesh.data_axes(mesh), tmesh.num_learners(mesh)
    B = tspecs.SHAPES[shape]["batch"]
    ttree, jtree = _tcaches(arch, shape), _jcaches(arch, shape)
    got = shd.cache_pspec(ttree, daxes, B, nd, 16)
    want = jshd.cache_pspec(jtree, daxes, B, nd, 16)
    _assert_same_specs(got, want, ttree, jtree, _cache_map(arch), 0)


# ---------------------------------------------------------------------------
# Per-device bytes
# ---------------------------------------------------------------------------


def _ref_bytes(jtree, jpspecs, sizes) -> int:
    """One device's bytes of a reference tree under its partition specs
    on a mesh of axis ``sizes``."""
    leaves, specs = _jflat(jtree), _jflat(jpspecs)
    total = 0
    for path, leaf in leaves.items():
        spec = tuple(specs[path])
        n = 1
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            k = math.prod(sizes[a] for a in axes)
            assert dim % k == 0
            n *= dim // k
        total += n * jnp.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCHS)
def test_per_device_bytes_match_reference(arch, multi_pod):
    mesh = tmesh.make_production_mesh(multi_pod=multi_pod)
    sizes = MESHES[multi_pod]
    assert mesh.shape == sizes
    daxes, nd = tmesh.data_axes(mesh), tmesh.num_learners(mesh)
    cfg = tget(arch)
    # parameters, unstacked and stacked over the learner axes
    got = shd.per_device_bytes(_tparams(arch),
                               shd.param_pspec(_tparams(arch), 16), mesh)
    want = _ref_bytes(_jparams(arch), jshd.param_pspec(_jparams(arch), 16),
                      sizes)
    assert got == want
    stacked, jstacked = tspecs.stacked_param_specs(cfg, nd), \
        _jstack(_jparams(arch), nd)
    got = shd.per_device_bytes(stacked,
                               shd.param_pspec(stacked, 16, daxes), mesh)
    want = _ref_bytes(jstacked, jshd.param_pspec(jstacked, 16, daxes), sizes)
    assert got == want
    # the full trees' bytes are the same too
    assert shd.per_device_bytes(
        stacked, shd.param_pspec(stacked, 1), tmesh.NamedMesh(
            ("model",), (1,))) == _ref_bytes(
        jstacked, jshd.param_pspec(jstacked, 1), {"model": 1})
    # decode caches
    for shape in ("decode_32k", "long_500k"):
        B = tspecs.SHAPES[shape]["batch"]
        ttree, jtree = _tcaches(arch, shape), _jcaches(arch, shape)
        got = shd.per_device_bytes(
            ttree, shd.cache_pspec(ttree, daxes, B, nd, 16), mesh)
        want = _ref_bytes(jtree, jshd.cache_pspec(jtree, daxes, B, nd, 16),
                          sizes)
        assert got == want, shape


# ---------------------------------------------------------------------------
# train_state_specs
# ---------------------------------------------------------------------------


def _assert_same_stacked_tree(ttree, jtree, prefixes):
    """Every port leaf of a learner-stacked tree has its reference leaf's
    shape (the repeat dim after the learner dim dropped) and dtype, and
    every reference leaf is some port leaf's."""
    tl, jl = _tflat(ttree), _jflat(jtree)
    seen = set()
    for path, leaf in tl.items():
        ref, stacked = _ref_path(path, prefixes)
        jleaf = jl[ref]
        jshape = _drop(jleaf.shape, 1) if stacked else tuple(jleaf.shape)
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == jshape, path
        assert str(leaf.dtype).split(".")[1] == str(jleaf.dtype), path
        seen.add(ref)
    assert seen == set(jl) and seen


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_train_state_specs_match_reference(arch):
    m = 16
    got = train_state_specs(tget(arch), m, OptimizerConfig(
        kind="sgd", lr=1e-2, momentum=0.9))
    want = jtrain_state_specs(jget(arch), m, JOptimizerConfig(
        kind="sgd", lr=1e-2, momentum=0.9))
    prefixes = _param_map(arch)
    for name in ("params", "opt"):
        _assert_same_stacked_tree(getattr(got, name), getattr(want, name),
                                  prefixes)
    _assert_same_stacked_tree(got.pstate.reference, want.pstate.reference,
                              prefixes)
    for field in ("step", "syncs", "bytes_sent", "last_divergence",
                  "delta_scale"):
        t, j = getattr(got.pstate, field), getattr(want.pstate, field)
        assert tuple(t.shape) == tuple(j.shape) == ()
        assert str(t.dtype).split(".")[1] == str(j.dtype), field
    assert got.step.device.type == "meta" and got.step.dtype == torch.int32
    assert str(want.step.dtype) == "int32"


# ---------------------------------------------------------------------------
# Meshes and specs on them
# ---------------------------------------------------------------------------


def test_production_meshes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert (single.axis_names, single.shape, single.size) == (
        ("data", "model"), {"data": 16, "model": 16}, 256)
    assert (multi.axis_names, multi.size) == (("pod", "data", "model"), 512)
    assert single.devices == () and multi.devices == ()
    assert tmesh.data_axes(single) == ("data",)
    assert tmesh.num_learners(single) == 16
    assert tmesh.data_axes(multi) == ("pod", "data")
    assert tmesh.num_learners(multi) == 32
    with pytest.raises(ValueError):
        tmesh.NamedMesh(("data", "data"), (2, 2))
    with pytest.raises(ValueError):
        tmesh.NamedMesh(("data",), (2,), (torch.device("cpu"),))


def test_host_mesh_spans_the_devices_given():
    mesh = tmesh.make_host_mesh(2, 2, devices=["cpu"] * 5)
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError, match="needs 8 devices"):
        tmesh.make_host_mesh(4, 2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_host_mesh(1, 1)


def test_hardware_constants_are_the_h100s():
    assert tmesh.PEAK_FLOPS_BF16 == 989e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.LINK_BW == 450e9


def test_specs_on_a_mesh():
    mesh = tmesh.make_production_mesh(multi_pod=True)
    x = torch.empty((64, 48, 5), device="meta")
    spec = shd.PSpec(("pod", "data"), "model")
    assert shd.per_device_shape(x.shape, spec, mesh) == (2, 3, 5)
    assert shd.per_device_bytes({"x": x}, {"x": spec}, mesh) == 2 * 3 * 5 * 4
    sh = shd.to_shardings(mesh, {"x": spec}, {"x": x})
    assert sh["x"] == shd.NamedSharding(mesh, spec)
    assert sh["x"].shard_shape(x.shape) == (2, 3, 5)
    for bad in (shd.PSpec("learners"), shd.PSpec("data", "data"),
                shd.PSpec(None, None, "model")):
        with pytest.raises(ValueError):
            shd.to_shardings(mesh, {"x": bad}, {"x": x})
    with pytest.raises(ValueError, match="no axis"):
        shd.to_shardings(mesh, [shd.PSpec("learners")])
    assert repr(spec) == "PSpec(('pod', 'data'), 'model')"
