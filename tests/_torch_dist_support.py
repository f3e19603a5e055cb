"""Multi-rank runs of the port's mesh paths on the CPU, for
``tests/test_torch_distributed*.py``.

``run_ranks(case, world, workdir)`` starts ``world`` interpreters running
this file, one a rank, joined as a gloo group through a ``FileStore`` in
``workdir`` (a TCP port would collide between parallel test workers).
Each rank runs ``CASES[case]`` with torch on one thread, reading its
inputs from ``workdir/in.npz`` and writing ``workdir/out_<rank>.npz``.
Nothing here imports JAX: the reference's side runs in its own
subprocess (the ``subproc`` fixture)."""
import os
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_ranks(case: str, world: int, workdir, timeout: float = 300.0,
              **kw):
    """Run ``case`` on ``world`` ranks; returns each rank's outputs (a
    dict of arrays).  ``kw`` reaches the case as strings."""
    workdir = pathlib.Path(workdir)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    args = [f"{k}={v}" for k, v in kw.items()]
    procs = [subprocess.Popen(
        [sys.executable, __file__, case, str(rank), str(world),
         str(workdir)] + args, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for rank in range(world)]
    fails = []
    for rank, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise AssertionError(f"{case}: rank {rank} timed out")
        if p.returncode:
            fails.append(f"rank {rank} exited {p.returncode}:\n{err}")
    assert not fails, "\n".join(fails)
    return [dict(np.load(workdir / f"out_{rank}.npz"))
            for rank in range(world)]


def unflatten(flat, prefix):
    """A nest of dicts from ``{"a/b/c": array}`` keys under ``prefix``."""
    tree = {}
    for key, val in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, parts = tree, key[len(prefix) + 1:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return tree


def flatten(tree, prefix):
    """``{prefix/a/b: leaf}`` for a nest of dicts and lists (a list item
    named by its index)."""
    if isinstance(tree, (dict, list, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


# -- the cases (run inside a rank) --------------------------------------------

def _pipeline(rank, world, inp, kw):
    import torch
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((world,), ("pipe",), device="cpu")
    ws = torch.from_numpy(inp["ws"])
    x = torch.from_numpy(inp["x"])
    y = pipeline_apply(lambda w, h: torch.tanh(h @ w), mesh, "pipe",
                       ws[rank], x)
    return {"y": y.numpy()}


def _compress(rank, world, inp, kw):
    import torch
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import compression as comp
    from repro_torch.launch.mesh import make_mesh
    # the batch over two axes: their group is the mesh's flattened plane
    mesh = make_mesh((2, world // 2), ("pod", "data"), device="cpu")
    params = {"w": torch.from_numpy(inp["w"])}
    xb, yb = torch.from_numpy(inp["x"]), torch.from_numpy(inp["y"])
    rows = xb.shape[0] // world
    local = {"x": xb[rank * rows:(rank + 1) * rows],
             "y": yb[rank * rows:(rank + 1) * rows]}

    def loss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)
    grads = comp.make_compressed_dp_grad_fn(loss, mesh, ("pod", "data"))(
        params, local)
    return {"w": grads["w"].numpy(),
            "host_copies": np.asarray(coll.host_copies)}


def _moe(rank, world, inp, kw):
    """``kw["setups"]``: ``name:experts:top_k:capacity_factor`` items,
    each one MoE layer of reduced ``kw["arch"]`` (``name/moe/...``) on
    tokens ``name/x``, through ``moe_ep`` and ``moe_layer``'s dispatch on
    a (data, model) mesh."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import context as dist_ctx
    from repro_torch.distributed.sharding import local_shard
    from repro_torch.launch.mesh import make_mesh, mesh_coords
    from repro_torch.models import moe
    from repro_torch.models.params import from_reference
    data, model = int(kw["data"]), int(kw["model"])
    mesh = make_mesh((data, model), ("data", "model"), device="cpu")
    ctx = dist_ctx.ParallelContext(mesh=mesh, batch_axes=("data",),
                                   model_axis="model", ep_axes=("data",))
    coords = mesh_coords(mesh)
    out = {"coords": np.asarray([coords["data"], coords["model"]])}
    for setup in kw["setups"].split(","):
        name, e, k, cf = setup.split(":")
        cfg = get_config(kw["arch"]).reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=int(e), top_k=int(k), impl="ep",
            capacity_factor=float(cf)))
        p = from_reference(unflatten(inp, f"{name}/moe"), device="cpu")
        x_local = local_shard(torch.from_numpy(inp[f"{name}/x"]),
                              (("data",), None), mesh)
        moe.ep_calls = moe.ep_dropped = 0
        with torch.no_grad(), dist_ctx.use(ctx):
            y, aux = moe.moe_ep(p, cfg, x_local)
            dropped = moe.ep_dropped
            y_layer, _ = moe.moe_layer(p, cfg, x_local[None])
        calls = moe.ep_calls
        # the same with the experts as DTensors placed by their specs
        from torch.distributed.tensor import DTensor
        from repro_torch.distributed.sharding import placements
        tp = ("model",)
        routed = {}
        for key, w in p["routed"].items():
            spec = (("data",), tp, None) if key == "w_down" else (
                ("data",), None, tp)
            routed[key] = DTensor.from_local(
                local_shard(w, spec, mesh), mesh, placements(spec, mesh),
                run_check=False)
        with torch.no_grad(), dist_ctx.use(ctx):
            y_dt, _ = moe.moe_ep(dict(p, routed=routed), cfg, x_local)
        out.update({f"{name}/y": y.numpy(), f"{name}/aux": aux.numpy(),
                    f"{name}/y_dtensor": y_dt.numpy(),
                    f"{name}/y_layer": y_layer[0].numpy(),
                    f"{name}/calls": np.asarray(calls),
                    f"{name}/dropped": np.asarray(dropped)})
    return out


def _moe_bytes(rank, world, inp, kw):
    """``moe_ep`` of reduced ``kw["arch"]`` (experts ``kw["experts"]``
    top-``kw["top_k"]``, capacity factor ``kw["cf"]``) on ``kw["tokens"]``
    seeded tokens a data shard, on a (data, model) mesh: the bytes this rank put
    into all-to-alls, counted by ``distributed.collectives``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed import context as dist_ctx
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    data, model = int(kw["data"]), int(kw["model"])
    mesh = make_mesh((data, model), ("data", "model"), device="cpu")
    ctx = dist_ctx.ParallelContext(mesh=mesh, batch_axes=("data",),
                                   model_axis="model", ep_axes=("data",))
    cfg = get_config(kw["arch"]).reduced()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=int(kw["experts"]), top_k=int(kw["top_k"]),
        impl="ep", capacity_factor=float(kw["cf"])))
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu", data_shards=data)
    p = params["layers"][0]["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {n: w[0] for n, w in v.items()}) for k, v in p.items()}
    # a data shard's tokens, the same on each rank of its model group
    from repro_torch.launch.mesh import mesh_coords
    x = torch.randn((int(kw["tokens"]), cfg.d_model),
                    generator=torch.Generator().manual_seed(
                        1 + mesh_coords(mesh)["data"]))
    coll.reset_counts()
    with torch.no_grad(), dist_ctx.use(ctx):
        moe.moe_ep(p, cfg, x)
    return {"all_to_all": np.asarray(coll.bytes_moved["all-to-all"]),
            "all_reduce": np.asarray(coll.bytes_moved.get("all-reduce", 0))}


CASES = {"pipeline": _pipeline, "compress": _compress, "moe": _moe,
         "moe_bytes": _moe_bytes}


def main(argv):
    case, rank, world, workdir = argv[0], int(argv[1]), int(argv[2]), \
        pathlib.Path(argv[3])
    kw = dict(a.split("=", 1) for a in argv[4:])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(workdir / f"store_{case}"), world), rank=rank,
        world_size=world)
    try:
        out = CASES[case](rank, world, dict(np.load(workdir / "in.npz")),
                          kw)
        np.savez(workdir / f"out_{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
