"""The router's training entry point (the port of
``repro.training.train_loop.train_router``).

The reference module also builds the LM train step
(``symmetrize_ep_grads``, ``make_train_step``, ``init_train_state``);
that belongs to LM training, which a later slice of the port brings.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional


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
