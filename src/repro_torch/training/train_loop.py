"""Train-step construction (the port of ``repro.training.train_loop``):
grads by autograd through ``models.model.loss_fn``, EP replica
symmetrization, an optional gradient-compression hook, the AdamW update;
and the router's training entry point ``train_router``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.training import optimizer as opt_lib


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        # list items carry no key, as in the reference's path names
        return type(tree)(_map_with_path(fn, v, path + ("",))
                          for v in tree)
    return fn(path, tree)


def symmetrize_ep_grads(cfg: ModelConfig, grads):
    """Average gradients across EP replica slots (the reference's rule).

    When E < n_ep_shards, routed expert weights are stored replicated
    (slot s holds expert s // R); the replicas receive different
    gradients and are re-synchronized.  The port stores no replicas, so
    on its configs this is the identity; it acts on trees that hold
    them."""
    if cfg.moe is None or cfg.moe.impl != "ep":
        return grads
    e = cfg.moe.n_experts

    def one(names, g):
        if "routed" not in names or names[-1] not in ("w_up", "w_down",
                                                      "w_gate"):
            return g
        ax = 1 if "layers" in names else 0
        if g.shape[ax] == e:
            return g
        r = g.shape[ax] // e
        shape = tuple(g.shape)
        grouped = g.reshape(shape[:ax] + (e, r) + shape[ax + 1:])
        mean = torch.mean(grouped, dim=ax + 1, keepdim=True)
        return mean.expand(grouped.shape).reshape(shape)

    return _map_with_path(one, grads)


def make_train_step(cfg: ModelConfig, opt_cfg: opt_lib.OptimizerConfig,
                    compress_grads: Optional[Callable] = None
                    ) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "lm_loss", "moe_aux", "grad_norm", "lr"}).

    ``params`` are leaf tensors with ``requires_grad`` (see
    :func:`init_train_state`); ``batch`` holds tensors on their device.
    The step updates params and moments IN PLACE (the returned trees are
    the ones passed in) and leaves no ``.grad`` behind; the metrics stay
    tensors (no host sync).  ``compress_grads`` optionally maps the grad
    tree (quantize -> all-reduce -> dequantize)."""
    def train_step(params, opt_state, batch):
        loss, aux, grads = loss_and_grads(cfg, params, batch)
        if compress_grads is not None:
            grads = compress_grads(grads)
        grads = symmetrize_ep_grads(cfg, grads)
        params, opt_state, metrics = opt_lib.update(opt_cfg, grads,
                                                    opt_state, params)
        metrics.update({"loss": loss, **aux})
        return params, opt_state, metrics

    return train_step


def loss_and_grads(cfg: ModelConfig, params, batch):
    """``loss_fn`` and its gradients by autograd: (loss, aux, grad tree),
    the loss and aux detached.  A leaf no path reaches gets a zero
    gradient, as ``jax.grad`` gives it; no ``.grad`` is left behind."""
    from repro_torch.models import model as model_lib
    from repro_torch.models.params import leaves, tree_map
    for p in leaves(params):
        p.grad = None
    loss, aux = model_lib.loss_fn(params, cfg, batch)
    loss.backward()
    grads = tree_map(lambda p: p.grad if p.grad is not None
                     else torch.zeros_like(p), params)
    for p in leaves(params):
        p.grad = None
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda"):
    """(params, AdamW state) on ``device``: the parameters of
    ``models.params.init_params``, each leaf requiring grad."""
    from repro_torch.models import params as params_lib
    params = params_lib.init_params(cfg, generator, device=device)
    for p in params_lib.leaves(params):
        p.requires_grad_(True)
    return params, opt_lib.init(params)


# -- router-RL training entrypoint ------------------------------------------

def train_router(router_cfg, scenario_fn, n_episodes: int,
                 batched: bool = True, batch_cfg=None, agent=None,
                 predict_decode: Optional[Callable] = None,
                 length_predictor=None,
                 valid_fn: Optional[Callable] = None,
                 verbose: bool = False, device="cuda") -> Dict[str, Any]:
    """Unified entrypoint for training the routing policy.

    ``scenario_fn(ep)`` yields a `workload.Scenario` per episode.  The
    default path is the batched multi-episode runner
    (`core.batched_rl.train_batched`); ``batched=False`` falls back to
    the sequential paper-faithful loop, which requires every scenario to
    be homogeneous (one hardware profile, cfg.n_instances wide).
    Without an ``agent`` a fresh one is built on ``device``.

    ``length_predictor`` (a `core.predictor.BucketPredictor`) puts the
    LEARNED length estimate in the training loop: each scenario's
    requests are stamped with predictor d-hats (one batched forward per
    episode) and the env's ``predict_decode`` reads the stamp -- the
    router trains on the same imperfect signal it serves with, instead
    of the oracle decode length.
    """
    from repro_torch.core import batched_rl, rl_router

    if length_predictor is not None:
        from repro_torch.core import predictor as pred_lib
        if predict_decode is not None:
            raise ValueError(
                "pass either predict_decode or length_predictor")
        scenario_fn = pred_lib.annotating_stream(scenario_fn,
                                                 length_predictor)
        predict_decode = pred_lib.predicted_decode
        if valid_fn is not None:
            inner_valid = valid_fn

            def valid_fn():
                scn = inner_valid()
                if scn.samples is not None:
                    pred_lib.annotate_requests(length_predictor,
                                               scn.requests, scn.samples)
                return scn

    if batched:
        return batched_rl.train_batched(
            router_cfg, scenario_fn, n_episodes, bcfg=batch_cfg,
            agent=agent, predict_decode=predict_decode,
            valid_fn=valid_fn, verbose=verbose, device=device)
    probe = scenario_fn(0)
    if len(set(probe.profiles)) != 1 or probe.m != router_cfg.n_instances:
        raise ValueError(
            "sequential trainer needs homogeneous scenarios of width "
            f"cfg.n_instances={router_cfg.n_instances}; got m={probe.m}")
    return rl_router.train(
        router_cfg, probe.profiles[0],
        lambda ep: scenario_fn(ep).requests, n_episodes, agent=agent,
        predict_decode=predict_decode,
        valid_fn=(lambda: valid_fn().requests) if valid_fn else None,
        verbose=verbose, device=device)
