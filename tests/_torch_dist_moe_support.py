"""Shared set-up of the expert-parallel MoE tests
(``tests/test_torch_distributed_moe*.py``): the reference's MoE layers
and ``moe_ep`` outputs from one subprocess on 8 host devices
(``conftest.run_subprocess``, the ``subproc`` fixture's runner, as
``tests/test_distributed.py`` uses it), the port's ``moe_ep`` on one
gloo group of CPU ranks (``_torch_dist_support.run_ranks``) with the same
parameters carried over by value, and the port's single-device ragged
path over all the tokens."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import moe as pt_moe
from repro_torch.models import params as pt_params

from _torch_dist_support import run_ranks, unflatten

ARCH = "deepseek-moe-16b"
DATA, MODEL, T = 4, 2, 32

# the reference's side: for each setup one MoE layer of reduced deepseek
# (``init_moe``; R equal copies of each expert where stored > E), its
# moe_ragged and its moe_ep on the (DATA, MODEL) host mesh, into {path}
REF_MOE = """
    import dataclasses, jax, jax.numpy as jnp, numpy as np
    from repro.configs import REGISTRY
    from repro.models import params as P, moe as MoE
    from repro.distributed import context as dist_ctx
    from repro.launch import mesh as mesh_lib
    from repro.launch.mesh import make_mesh
    mesh = make_mesh(({data}, {model}), ('data', 'model'))
    ctx = dist_ctx.ParallelContext(
        mesh=mesh, batch_axes=('data',), model_axis='model',
        ep_axes=('data',))
    out = {{}}
    def put(tree, prefix):
        for key, val in tree.items():
            if isinstance(val, dict):
                put(val, prefix + '/' + key)
            else:
                out[prefix + '/' + key] = np.asarray(val)
    for i, (name, e, k, store, cf) in enumerate({setups!r}):
        cfg = REGISTRY['{arch}'].reduced()
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, n_experts=e, top_k=k, impl='ragged'))
        moe_p = P.init_moe(jax.random.PRNGKey(i), cfg, jnp.float32, 0)
        if store > e:   # slot s holds a copy of expert s // R
            moe_p['routed'] = jax.tree.map(
                lambda w: jnp.repeat(w, store // e, axis=0),
                moe_p['routed'])
        x = np.random.default_rng(5 + i).standard_normal(
            ({t}, cfg.d_model)).astype(np.float32)
        yr, auxr = jax.jit(lambda p, x: MoE.moe_ragged(p, cfg, x))(moe_p, x)
        cfg_ep = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, impl='ep', capacity_factor=cf))
        with dist_ctx.use(ctx), mesh_lib.set_mesh(mesh):
            yep, auxep = jax.jit(
                lambda p, x: MoE.moe_ep(p, cfg_ep, x))(moe_p, x)
        put(moe_p, name + '/moe')
        out.update({{name + '/x': x, name + '/yr': np.asarray(yr),
                    name + '/auxr': np.asarray(auxr),
                    name + '/yep': np.asarray(yep),
                    name + '/auxep': np.asarray(auxep)}})
    np.savez('{path}', **out)
    print('OK')
"""



def pt_cfg(e, k, cf, impl="ep"):
    cfg = get_config(ARCH).reduced()
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=e, top_k=k, impl=impl, capacity_factor=cf))


def moe_runs(work, setups):
    """For each (name, experts, top_k, stored slots, capacity factor)
    setup: the reference's arrays (``name/...``), every rank's outputs,
    and the port's ragged (y, aux) and ragged ``moe_layer`` y over all
    the tokens."""
    from conftest import run_subprocess
    out = run_subprocess(REF_MOE.format(
        arch=ARCH, data=DATA, model=MODEL, t=T, setups=tuple(setups),
        path=work / "in.npz"), devices=8)
    assert "OK" in out
    ref = dict(np.load(work / "in.npz"))
    outs = run_ranks("moe", DATA * MODEL, work, arch=ARCH, data=DATA,
                     model=MODEL, setups=",".join(
                         f"{n}:{e}:{k}:{cf}" for n, e, k, _, cf in setups))
    plain = {}
    for name, e, k, _, cf in setups:
        p = pt_params.from_reference(unflatten(ref, f"{name}/moe"),
                                     device="cpu")
        x = torch.from_numpy(ref[f"{name}/x"])
        with torch.no_grad():
            y_rag, aux_rag = pt_moe.moe_ragged(p, pt_cfg(e, k, cf), x)
            y_lay, _ = pt_moe.moe_layer(p, pt_cfg(e, k, cf, "ragged"),
                                        x[None])
        plain[name] = (y_rag.numpy(), float(aux_rag), y_lay[0].numpy())
    return ref, outs, plain


def rows(outs, key):
    """The ranks' local rows in data-coordinate order (model rank 0)."""
    by_data = {int(o["coords"][0]): o[key] for o in outs
               if int(o["coords"][1]) == 0}
    return np.concatenate([by_data[i] for i in range(DATA)])
