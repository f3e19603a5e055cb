"""The port's mesh code in one process: the sharding rules and the shape
stand-ins against the JAX reference's for every config of ``REGISTRY``
at the production sizes (plain ``(axis names, sizes)`` meshes on the
port's side, ``jax.sharding.AbstractMesh`` on the reference's: no 256
processes or devices), the parallel context, the spec helpers, the
expanded KV cache under a 16-wide model axis, and ``moe_layer``'s
dispatch table."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.common.config import shapes_for as ref_shapes_for
from repro.configs import REGISTRY as REF_REGISTRY
from repro.distributed import context as ref_ctx
from repro.distributed import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro_torch.common.config import shapes_for
from repro_torch.configs import REGISTRY, get_config
from repro_torch.distributed import context as dist_ctx
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps
from repro_torch.models import model as pt_model
from repro_torch.models import moe as pt_moe
from repro_torch.models import params as pt_params

DATA_SHARDS = 16
MESHES = (False, True)          # single pod, multi pod


def _meshes(multi_pod):
    axes, shape = mesh_lib.production_axes(multi_pod)
    return (axes, shape), AbstractMesh(shape, axes)


def _norm(spec):
    """A reference PartitionSpec as the port writes specs: one entry a
    dim, None or a tuple of axis names."""
    return tuple(None if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in spec)


def _ref_flat(tree):
    """{path names: leaf} of a reference tree (NamedSharding leaves too)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        out[ref_sharding._path_names(path)] = leaf
    return out


def _pt_flat(tree, names=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_pt_flat(v, names + (str(k),)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_pt_flat(v, names + (f"[{i}]",)))
        return out
    return {names: tree}


def _specs_equal(pt_tree, ref_tree):
    """Every leaf's spec equal.  The reference may write a spec shorter
    than the tensor's dims (trailing dims unsharded)."""
    pt, ref = _pt_flat(pt_tree), _ref_flat(ref_tree)
    assert pt.keys() == ref.keys()
    for key, spec in pt.items():
        want = _norm(ref[key].spec)
        want = want + (None,) * (len(spec) - len(want))
        assert spec == want, (key, spec, want)
    return len(pt)


def _ref_ctx(amesh):
    return ref_ctx.ParallelContext(
        mesh=amesh, batch_axes=tuple(a for a in amesh.axis_names
                                     if a in ("pod", "data")),
        model_axis="model", ep_axes=("data",))


def _pt_ctx(mesh):
    return dist_ctx.ParallelContext(mesh=mesh,
                                    batch_axes=mesh_lib.batch_axes(mesh),
                                    model_axis="model", ep_axes=("data",))


@pytest.mark.parametrize("multi_pod", MESHES, ids=("single", "multi"))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_shardings_match_the_reference(arch, multi_pod):
    """(i) ``param_spec`` on every leaf of every config (the shape
    stand-ins at data_shards=16), train and serve, the optimizer state's
    leaves too."""
    pt_mesh, amesh = _meshes(multi_pod)
    cfg, cfg_ref = get_config(arch), REF_REGISTRY[arch]
    p_pt = steps.param_specs(cfg, DATA_SHARDS)
    p_ref = ref_steps.param_specs(cfg_ref, DATA_SHARDS)
    for mode in ("train", "serve"):
        n = _specs_equal(
            sharding.params_shardings(cfg, p_pt, pt_mesh, mode),
            ref_sharding.params_shardings(cfg_ref, p_ref, amesh, mode))
        assert n >= 10
    opt = "adafactor" if cfg.count_params() > 1e11 else "adamw"
    o_pt = steps.opt_specs(cfg, DATA_SHARDS, opt)
    o_ref = ref_steps.opt_specs(cfg_ref, DATA_SHARDS, opt)
    _specs_equal(sharding.params_shardings(cfg, o_pt, pt_mesh, "train"),
                 ref_sharding.params_shardings(cfg_ref, o_ref, amesh,
                                               "train"))


@pytest.mark.parametrize("multi_pod", MESHES, ids=("single", "multi"))
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_input_and_cache_shardings_match_the_reference(arch, multi_pod):
    """(i) ``input_shardings`` for every shape of ``shapes_for(cfg)``, and
    ``cache_shardings`` with and without ``seq_parallel`` for the decode
    shapes, each cache laid out under the context (expanded KV heads where
    the model axis divides H but not KV)."""
    pt_mesh, amesh = _meshes(multi_pod)
    cfg, cfg_ref = get_config(arch), REF_REGISTRY[arch]
    assert [s.name for s in shapes_for(cfg)] == [
        s.name for s in ref_shapes_for(cfg_ref)]
    for shape, shape_ref in zip(shapes_for(cfg), ref_shapes_for(cfg_ref)):
        _specs_equal(
            sharding.input_shardings(cfg, pt_mesh,
                                     steps.input_specs(cfg, shape)),
            ref_sharding.input_shardings(
                cfg_ref, amesh, ref_steps.input_specs(cfg_ref, shape_ref)))
        with dist_ctx.use(_pt_ctx(pt_mesh)):
            c_pt = steps.cache_specs(cfg, shape)
        with ref_ctx.use(_ref_ctx(amesh)):
            c_ref = ref_steps.cache_specs(cfg_ref, shape_ref)
        for seq_parallel in (False, True):
            _specs_equal(
                sharding.cache_shardings(cfg, pt_mesh, c_pt, seq_parallel),
                ref_sharding.cache_shardings(cfg_ref, amesh, c_ref,
                                             seq_parallel))


def _shapes_equal(pt_tree, ref_tree):
    pt, ref = _pt_flat(pt_tree), _ref_flat(ref_tree)
    assert pt.keys() == ref.keys()
    for key, t in pt.items():
        assert t.device.type == "meta", key
        assert tuple(t.shape) == tuple(ref[key].shape), key
        assert str(t.dtype).removeprefix("torch.") == str(
            np.dtype(ref[key].dtype)), key
    return len(pt)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_shape_stand_ins_match_the_reference(arch):
    """(ii) ``input_specs``, ``cache_specs``, ``param_specs`` (with and
    without EP storage) and ``opt_specs`` (AdamW and Adafactor) have the
    reference's shapes and dtypes, on the meta device."""
    cfg, cfg_ref = get_config(arch), REF_REGISTRY[arch]
    for shape, shape_ref in zip(shapes_for(cfg), ref_shapes_for(cfg_ref)):
        _shapes_equal(steps.input_specs(cfg, shape),
                      ref_steps.input_specs(cfg_ref, shape_ref))
        _shapes_equal(steps.cache_specs(cfg, shape),
                      ref_steps.cache_specs(cfg_ref, shape_ref))
    for shards in (0, DATA_SHARDS):
        _shapes_equal(steps.param_specs(cfg, shards),
                      ref_steps.param_specs(cfg_ref, shards))
    for opt in ("adamw", "adafactor"):
        _shapes_equal(steps.opt_specs(cfg, DATA_SHARDS, opt),
                      ref_steps.opt_specs(cfg_ref, DATA_SHARDS, opt))


@pytest.mark.parametrize("arch,heads", [("qwen3-0.6b", 16),
                                        ("llama-3.2-vision-11b", 32),
                                        ("gemma-7b", 16),
                                        ("starcoder2-7b", 4)])
def test_cache_specs_under_a_16_wide_model_axis(arch, heads):
    """(ii) Under a context with a 16-wide model axis the cache stores
    expanded heads where 16 divides H but not KV (qwen3's 8 KV heads
    become its 16; llama-vision's 8 its 32, the cross layers' too), as the
    reference's ``init_cache`` lays it out; gemma's 16 and starcoder2's 4
    (36 query heads) stay."""
    pt_mesh, amesh = _meshes(False)
    cfg, cfg_ref = get_config(arch), REF_REGISTRY[arch]
    shape, shape_ref = shapes_for(cfg)[2], ref_shapes_for(cfg_ref)[2]
    assert shape.kind == "decode"
    with dist_ctx.use(_pt_ctx(pt_mesh)):
        assert pt_model.cache_kv_heads(cfg) == heads
        c_pt = steps.cache_specs(cfg, shape)
    with ref_ctx.use(_ref_ctx(amesh)):
        c_ref = ref_steps.cache_specs(cfg_ref, shape_ref)
    _shapes_equal(c_pt, c_ref)
    attn = [e for e in c_pt["layers"] if "k" in e]
    assert attn and all(e["k"].shape[3] == heads for e in attn)
    assert pt_model.cache_kv_heads(cfg) == cfg.n_kv_heads   # no context


def test_sharding_fallbacks():
    """The reference's own cases (``tests/test_distributed.py``): 36 heads
    stay unsharded over 16, 16 heads shard; head_dim never."""
    mesh = (("data", "model"), (16, 16))
    spec = sharding.param_spec(("layers", "attn", "wq"), (1, 4608, 36, 128),
                               get_config("starcoder2-7b"), mesh, "train")
    assert spec == (None, ("data",), None, None)
    spec = sharding.param_spec(("layers", "attn", "wq"), (1, 3072, 16, 256),
                               get_config("gemma-7b"), mesh, "train")
    assert spec == (None, ("data",), ("model",), None)
    assert sharding.param_spec(("embed",), (256000, 3072),
                               get_config("gemma-7b"), mesh, "serve") == (
        ("model",), None)
    assert sharding.batch_spec(mesh, 8) == (None, None)
    assert sharding.batch_spec((("pod", "data", "model"), (2, 16, 16)),
                               64, 2) == (("pod", "data"), None, None)


def test_meshes_and_axes():
    """The production meshes' axes and sizes (a 16-wide model axis), the
    mesh helpers on plain meshes, and make_mesh's guards."""
    assert mesh_lib.production_axes() == (("data", "model"), (16, 16))
    assert mesh_lib.production_axes(True) == (("pod", "data", "model"),
                                              (2, 16, 16))

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 4, "model": 2}
    for mesh in (FakeMesh(), (("data", "model"), (4, 2)),
                 AbstractMesh((4, 2), ("data", "model"))):
        assert mesh_lib.axis_sizes(mesh) == {"data": 4, "model": 2}
        assert mesh_lib.mesh_axes(mesh) == ("data", "model")
        assert mesh_lib.batch_axes(mesh) == ("data",)
    assert mesh_lib.batch_axes((("pod", "data", "model"), (2, 2, 2))) == (
        "pod", "data")
    with pytest.raises(RuntimeError, match="process group"):
        mesh_lib.make_production_mesh(device="cpu")
    with pytest.raises(ValueError):
        mesh_lib.make_mesh((2, 2), ("data",), device="cpu")


def test_parallel_context():
    """``get``/``set_context``/``use``, ``tp_size``, ``data_shards`` and
    the hints' divisibility rule; the hints return their input."""
    assert dist_ctx.get().mesh is None
    assert dist_ctx.tp_size() == 1 and dist_ctx.data_shards() == 0
    mesh = (("pod", "data", "model"), (2, 4, 8))
    ctx = dist_ctx.ParallelContext(mesh=mesh, batch_axes=("pod", "data"),
                                   model_axis="model", ep_axes=("data",))
    x = torch.zeros(16, 3, 8, 5)
    with dist_ctx.use(ctx):
        assert dist_ctx.get() is ctx
        assert dist_ctx.tp_size() == 8 and dist_ctx.data_shards() == 4
        assert dist_ctx.constrain_heads(x) is x
        assert dist_ctx.constrain_batch(x) is x
        assert dist_ctx.heads_spec(x.shape) == (("pod", "data"), None,
                                                ("model",), None)
        assert dist_ctx.heads_spec((4, 3, 8, 5)) == (None, None,
                                                     ("model",), None)
        assert dist_ctx.heads_spec((16, 3, 6, 5)) is None
        assert dist_ctx.batch_spec_of(x.shape) == (("pod", "data"), None,
                                                   None, None)
        assert dist_ctx.batch_spec_of((12, 3)) is None
    assert dist_ctx.get().mesh is None
    prev = dist_ctx.get()
    dist_ctx.set_context(ctx)
    try:
        assert dist_ctx.get() is ctx
    finally:
        dist_ctx.set_context(prev)


def test_local_shard_and_placements():
    """A rank's block of a full tensor under a spec, major to minor over
    several axes, and the spec's DeviceMesh placements."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = (("pod", "data", "model"), (2, 2, 3))
    x = torch.arange(8 * 6).reshape(8, 6)
    spec = (("pod", "data"), ("model",))
    blocks = {}
    for pod in range(2):
        for data in range(2):
            for model in range(3):
                blk = sharding.local_shard(
                    x, spec, mesh, {"pod": pod, "data": data,
                                    "model": model})
                assert blk.shape == (2, 2)
                blocks[(pod * 2 + data, model)] = blk
    full = torch.cat([torch.cat([blocks[(i, j)] for j in range(3)], 1)
                      for i in range(4)])
    assert torch.equal(full, x)
    assert sharding.placements(spec, mesh) == [Shard(0), Shard(0), Shard(1)]
    assert sharding.placements((None, ("model",)), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError):
        sharding.placements((("data", "pod"), None), mesh)
    with pytest.raises(ValueError):
        sharding.local_shard(torch.zeros(5, 6), spec, mesh,
                             {"pod": 0, "data": 0, "model": 0})


@pytest.mark.parametrize("impl", ["ep", "ragged", "dense"])
def test_moe_layer_dispatch_table(monkeypatch, impl):
    """(vii) The reference's dispatch: ``ep`` with a mesh runs moe_ep
    (even at 8 rows or fewer), ``gather`` where the rows do not divide
    over the batch shards or are fewer than they, ``ragged`` without a
    mesh; any other impl at 8 rows or fewer runs ``gather``."""
    cfg = get_config("deepseek-moe-16b").reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl=impl))
    p = pt_model._index(pt_params.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")["layers"][0],
        0)["moe"]
    calls = []

    def record(name):
        def fn(p_, cfg_, x):
            calls.append(name)
            return x, torch.zeros(())
        return fn
    for name in pt_moe.IMPLS:
        monkeypatch.setitem(pt_moe.IMPLS, name, record(name))
    monkeypatch.setattr(pt_moe, "moe_ep", record("ep"))
    mesh = (("data", "model"), (4, 2))
    ctx = dist_ctx.ParallelContext(mesh=mesh, batch_axes=("data",),
                                   model_axis="model", ep_axes=("data",))
    rows = (8, 9, 12, 16, 2)
    for context in (None, ctx):
        for t in rows:
            x = torch.zeros(1, t, cfg.d_model)
            if context is None:
                pt_moe.moe_layer(p, cfg, x)
            else:
                with dist_ctx.use(context):
                    pt_moe.moe_layer(p, cfg, x)
    if impl == "ep":
        want = ["gather", "ragged", "ragged", "ragged", "gather",
                "ep", "gather", "ep", "ep", "gather"]
    else:
        want = ["gather", impl, impl, impl, "gather"] * 2
    assert calls == want
