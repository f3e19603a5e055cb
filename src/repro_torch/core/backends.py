"""Unified simulator-backend registry (the port's own copy of
``repro.core.backends``).

Every place that picks a simulator by name -- ``Cluster(backend=)``,
``GatewayConfig.backend``, ``BatchedRLConfig.backend``, the CLI's
``--backend`` -- resolves it here:

    from repro_torch.core.backends import make_backend
    cluster = make_backend("vec").make_cluster(profile, 4)
    pool = make_backend("vec").make_pool(n_episodes=8)

Registered backends:

  * ``py``     -- the per-instance Python reference stepper (the oracle).
  * ``vec``    -- numpy structure-of-arrays pool, bit-exact vs ``py``.
  * ``jax``    -- the device-resident pool (``core.jaxsim``): the vec
                  layout with its round loop as one CUDA kernel launch
                  a call; decision/clock bit-parity with ``vec``.  Its
                  factories take ``device`` (the card unless the caller
                  asks for the CPU, where the kernel's plain version
                  runs).
  * ``engine`` -- real reduced-model engines behind
                  ``EngineClusterAdapter`` (needs constructed engines;
                  no pooled training form).

Pool-less backends raise ``ValueError`` from ``make_pool`` with a hint,
so the batched trainer's error messages stay actionable.
"""
from __future__ import annotations

from typing import Callable, Dict, Protocol, runtime_checkable


@runtime_checkable
class SimBackend(Protocol):
    """What a simulator backend must provide.

    ``make_cluster`` returns an object satisfying the Cluster protocol
    (enqueue/route/advance/collect, ``instances``, ``central``, ...);
    ``make_pool`` returns a multi-episode pool for the batched trainer
    (``VecSimPool``-shaped) or raises ``ValueError`` if the backend has
    no pooled form.
    """

    name: str

    def make_cluster(self, profile, n_instances: int, **kw): ...

    def make_pool(self, n_episodes: int, **kw): ...


_REGISTRY: Dict[str, Callable[[], "SimBackend"]] = {}


def register_backend(name: str):
    """Class decorator: ``@register_backend("vec")`` registers a
    zero-arg factory under ``name``.  Last registration wins (tests can
    shadow a backend)."""
    def deco(factory):
        _REGISTRY[name] = factory
        return factory
    return deco


def available_backends() -> tuple:
    return tuple(sorted(_REGISTRY))


def make_backend(name: str) -> "SimBackend":
    """Resolve a backend name to a fresh ``SimBackend`` instance."""
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown simulator backend {name!r}; "
            f"available: {', '.join(available_backends())}") from None
    return factory()


# -- built-in backends (lazy imports: the registry must be importable
# -- from simulator.py without a cycle) --------------------------------

@register_backend("py")
class PyBackend:
    """Per-instance Python reference stepper -- the parity oracle."""

    name = "py"

    def make_cluster(self, profile, n_instances, device=None, **kw):
        from repro_torch.core.simulator import Cluster
        kw.pop("backend", None)
        return Cluster(profile, n_instances, backend="py", **kw)

    def make_pool(self, n_episodes, **kw):
        raise ValueError(
            "the 'py' backend steps instances one object at a time and "
            "has no pooled form; use backend='vec' or 'jax' for the "
            "batched trainer")


@register_backend("vec")
class VecBackend:
    """Numpy structure-of-arrays pool (bit-exact vs 'py')."""

    name = "vec"
    # whether the pool lives on a device (takes ``device=``); the vec
    # pool is host numpy and ignores it
    placed = False

    def _pool_cls(self):
        from repro_torch.core.vecsim import VecSimPool
        return VecSimPool

    def make_cluster(self, profile, n_instances, device="cuda", **kw):
        from repro_torch.core.vecsim import VecCluster
        kw.pop("backend", None)
        if kw.get("pool") is None:
            pool_kw = {"device": device} if self.placed else {}
            kw["pool"] = self._pool_cls()(1, **pool_kw)
        return VecCluster(profile, n_instances, **kw)

    def make_pool(self, n_episodes, **kw):
        return self._pool_cls()(n_episodes, **kw)


@register_backend("jax")
class JaxBackend(VecBackend):
    """The vec layout with its round loop on the device (one kernel
    launch a ``_run_rounds`` call), on ``device``."""

    name = "jax"
    placed = True

    def _pool_cls(self):
        from repro_torch.core.jaxsim import JaxSimPool
        return JaxSimPool


@register_backend("engine")
class EngineBackend:
    """Real reduced-model engines behind the cluster adapter."""

    name = "engine"

    def make_cluster(self, profile, n_instances, engines=None, **kw):
        if engines is None:
            raise ValueError(
                "the 'engine' backend wraps real LLM engines: pass "
                "engines=[LLMInstance, ...] (see serving.fidelity for "
                "construction from a model config) — it cannot be "
                "built from a hardware profile alone")
        from repro_torch.serving.gateway import EngineClusterAdapter
        return EngineClusterAdapter(engines)

    def make_pool(self, n_episodes, **kw):
        raise ValueError(
            "the 'engine' backend has no pooled simulator form; "
            "train on 'vec' or 'jax' and evaluate on the engine")
