"""The port's pipeline (``distributed.pipeline.pipeline_apply``) and int8
gradient all-reduce (``distributed.compression``) on gloo groups of CPU
ranks, against sequential stages, the exact gradient and the JAX
reference's own functions on host devices (one subprocess for the
module, ``conftest.run_subprocess`` as the ``subproc`` fixture runs it);
the collectives' helper on a group of one; and ``moe_ep`` on one rank."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import collectives as coll
from repro_torch.models import params as pt_params

from _torch_dist_support import run_ranks

TOL = 1e-4
ARCH = "deepseek-moe-16b"
STAGES, MICRO, MB, D = 4, 8, 2, 16
SHARDS = 8

# the reference's pipeline over 4 of the 8 host devices and its
# compressed DP gradient over all 8, on inputs made here
REF_MESH = """
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.launch import mesh as mesh_lib
    from repro.launch.mesh import make_mesh
    from repro.distributed import pipeline as pp, compression as comp
    inp = dict(np.load('{path}'))
    pipe = Mesh(np.array(jax.devices()[:{stages}]), ('pipe',))
    y = pp.pipeline_apply(lambda w, x: jnp.tanh(x @ w), pipe, 'pipe',
                          jnp.asarray(inp['ws']), jnp.asarray(inp['x']))
    mesh = make_mesh(({shards},), ('data',))
    loss = lambda p, b: jnp.mean((b['x'] @ p['w'] - b['y']) ** 2)
    gf = comp.make_compressed_dp_grad_fn(
        loss, mesh, ('data',), {{'x': P('data', None), 'y': P('data', None)}})
    with mesh_lib.set_mesh(mesh):
        g = jax.jit(gf)({{'w': jnp.asarray(inp['w'])}},
                        {{'x': jnp.asarray(inp['bx']),
                          'y': jnp.asarray(inp['by'])}})
    np.savez('{out}', y=np.asarray(y), g=np.asarray(g['w']))
    print('OK')
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Seeded inputs, and the reference's pipeline and compressed
    gradient on them."""
    from conftest import run_subprocess
    work = tmp_path_factory.mktemp("mesh_ref")
    rng = np.random.default_rng(11)
    inp = {"ws": (rng.standard_normal((STAGES, D, D)) / 4).astype(
               np.float32),
           "x": rng.standard_normal((MICRO, MB, D)).astype(np.float32),
           "w": rng.standard_normal((16, 4)).astype(np.float32),
           "bx": rng.standard_normal((32, 16)).astype(np.float32),
           "by": rng.standard_normal((32, 4)).astype(np.float32)}
    np.savez(work / "in.npz", **inp)
    out = run_subprocess(REF_MESH.format(path=work / "in.npz",
                                         out=work / "ref.npz",
                                         stages=STAGES, shards=SHARDS),
                         devices=8)
    assert "OK" in out
    return inp, dict(np.load(work / "ref.npz"))


def test_pipeline_matches_sequential_and_the_reference(ref, tmp_path):
    """(iii) 4 ranks, 8 microbatches: every rank ends with the last
    stage's outputs, equal to the 4 stages run in sequence and to the
    reference's pipeline_apply, within 1e-5."""
    inp, want = ref
    np.savez(tmp_path / "in.npz", ws=inp["ws"], x=inp["x"])
    outs = run_ranks("pipeline", STAGES, tmp_path)
    seq = torch.from_numpy(inp["x"])
    for s in range(STAGES):
        seq = torch.tanh(seq @ torch.from_numpy(inp["ws"][s]))
    for o in outs:
        np.testing.assert_allclose(o["y"], seq.numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(o["y"], want["y"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(o["y"], outs[0]["y"])


def test_compressed_allreduce_matches_exact_and_the_reference(ref,
                                                              tmp_path):
    """(iv) 8 ranks on a (pod=2, data=4) mesh, the batch over both axes,
    each rank with its 4 rows: the int8 mean gradient within 5% of the
    exact full-batch gradient's max, and within one quantisation step
    (max over the ranks of max |g| / 127) of the reference's on an
    8-wide data axis."""
    inp, want = ref
    np.savez(tmp_path / "in.npz", w=inp["w"], x=inp["bx"], y=inp["by"])
    outs = run_ranks("compress", SHARDS, tmp_path)
    w = torch.from_numpy(inp["w"]).requires_grad_(True)
    bx, by = torch.from_numpy(inp["bx"]), torch.from_numpy(inp["by"])
    exact, = torch.autograd.grad(torch.mean((bx @ w - by) ** 2), [w])
    rows = bx.shape[0] // SHARDS
    amax = max(float(torch.autograd.grad(torch.mean(
        (bx[i * rows:(i + 1) * rows] @ w - by[i * rows:(i + 1) * rows])
        ** 2), [w])[0].abs().max()) for i in range(SHARDS))
    step = amax / 127
    for o in outs:
        np.testing.assert_array_equal(o["w"], outs[0]["w"])
        rel = np.abs(o["w"] - exact.numpy()).max() / float(
            exact.abs().max())
        assert rel < 0.05, rel
        assert np.abs(o["w"] - want["g"]).max() <= step * (1 + 1e-6)
        assert int(o["host_copies"]) == 0        # CPU tensors, no copies


def test_collectives_on_a_group_of_one(tmp_path):
    """The helper on a one-rank gloo group: all-reduce (sum, max),
    all-to-all and the ring shift leave the data as it is, and CPU
    tensors never take the host path."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        group = dist.group.WORLD
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        assert coll.all_reduce(x.clone(), "sum", group).equal(x)
        assert coll.all_reduce(x.clone(), "max", group).equal(x)
        assert coll.all_to_all(x, group).equal(x)
        assert coll.ring_shift(x, group).equal(x)
        for op in ("all_reduce", "all_to_all", "send_recv"):
            assert not coll.via_host(x, group, op)
        assert coll.host_copies == 0
    finally:
        dist.destroy_process_group()
def test_moe_ep_on_one_rank_equals_ragged(tmp_path):
    """On a (data=1, model=1) mesh of one gloo rank, moe_ep routes every
    pair to itself and runs the same expert groups as ragged: the
    output is ragged's bit for bit.  It refuses a plain axes mesh (it
    needs process groups) and autograd (it runs forward only)."""
    from repro_torch.distributed import context as dist_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as pt_model
    from repro_torch.models import moe as pt_moe
    cfg = get_config(ARCH).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           impl="ep"))
    p = pt_model._index(pt_params.init_params(
        cfg, torch.Generator().manual_seed(3), device="cpu")["layers"][0],
        0)["moe"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (37, cfg.d_model)).astype(np.float32))
    plain = dist_ctx.ParallelContext(mesh=(("data", "model"), (1, 1)),
                                     batch_axes=("data",),
                                     model_axis="model", ep_axes=("data",))
    with dist_ctx.use(plain), pytest.raises(TypeError):
        pt_moe.moe_ep(p, cfg, x)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        ctx = dataclasses.replace(plain, mesh=mesh)
        with dist_ctx.use(ctx):
            with torch.no_grad():
                y, aux = pt_moe.moe_ep(p, cfg, x)
            with pytest.raises(NotImplementedError):
                pt_moe.moe_ep(p, cfg, x.clone().requires_grad_(True))
        y_r, aux_r = pt_moe.moe_ragged(p, cfg, x)
        assert torch.equal(y, y_r) and torch.equal(aux, aux_r)
    finally:
        dist.destroy_process_group()
