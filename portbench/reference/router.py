"""The plain reference of the router's decision: the checkpoint's
Q-network (``weights.json``, written beside the checkpoint from the same
trained network) as plain float64 matrices, and the guided selection on
top of it: Q squashed to +-q_squash around the best allowed action, the
guidance prior added, disallowed actions excluded, the argmax taken.

The states, masks and priors are the program's (recorded at each
``agent.act`` call in the window): this checks the Q-network and the
selection, not the featurizer."""
from __future__ import annotations

import json

import numpy as np


def load(path):
    with open(path) as f:
        doc = json.load(f)
    return doc["meta"], {k: np.asarray(v, np.float64)
                         for k, v in doc["params"].items()}


def _mlp(p, prefix, x):
    n = sum(1 for k in p if k.startswith(prefix + ".w"))
    for i in range(n):
        x = x @ p[f"{prefix}.w{i}"] + p[f"{prefix}.b{i}"]
        if i < n - 1:
            x = np.maximum(x, 0.0)
    return x


def q_values(meta, p, state):
    """Q [n_actions] of one state (last action: defer)."""
    x = np.asarray(state, np.float64)
    if meta["q_arch"] == "mlp":
        return _mlp(p, "net", x)
    di, dr = meta["inst_dims"], meta["router_dims"]
    n = (x.shape[0] - dr) // di
    inst = x[:n * di].reshape(n, di)
    router = x[n * di:]
    h = np.maximum(_mlp(p, "trunk", np.concatenate(
        [inst, np.repeat(router[None], n, 0)], -1)), 0.0)
    q_route = _mlp(p, "route_head", h)[:, 0]
    q_defer = _mlp(p, "defer_head", np.concatenate([h.mean(0), router]))
    return np.concatenate([q_route, q_defer])


def select(q, mask, prior, q_squash):
    """The action and the margin between it and the runner-up."""
    q = np.array(q, np.float64)
    mask = np.asarray(mask, bool)
    if q_squash > 0:
        ref = np.max(np.where(mask, q, -np.inf))
        q = q_squash * np.tanh(q - (ref if np.isfinite(ref) else 0.0))
    if prior is not None:
        q = q + prior
    q[~mask] = -np.inf
    order = np.argsort(-q, kind="stable")
    margin = (q[order[0]] - q[order[1]]) if mask.sum() > 1 else np.inf
    return int(order[0]), float(margin)
