"""The port's simulator-backend registry (``core/backends.py``) against
the JAX package's: the names it lists, its errors, and the places that
resolve a backend through it -- ``Cluster(backend=)``, the gateway, the
CLI, ``RoutingEnv`` and ``BatchedRLConfig`` with their deprecated
``sim_backend`` spellings -- and the device-resident ``jax`` pool it
builds on the given device."""
import warnings

import pytest
import torch

from repro.core import backends as ref_backends
from repro_torch.core import backends as pt_backends
from repro_torch.core import batched_rl, rl_router as rl
from repro_torch.core.jaxsim import JaxSimPool
from repro_torch.core.profiles import V100_LLAMA2_7B as PROF
from repro_torch.core.simulator import Cluster
from repro_torch.core.vecsim import VecCluster, VecSimPool
from repro_torch.core.workload import Scenario, generate, to_requests
from repro_torch.launch import serve
from repro_torch.serving.gateway import (Gateway, GatewayConfig,
                                         simulator_cluster)
from repro_torch.serving.policies import make_gateway_policy


def test_registry_lists_the_reference_backends():
    assert pt_backends.available_backends() == \
        ref_backends.available_backends() == ("engine", "jax", "py", "vec")
    for name in pt_backends.available_backends():
        assert pt_backends.make_backend(name).name == name


def test_make_backend_unknown_name_lists_alternatives():
    for name in ("cuda", "nope"):
        with pytest.raises(ValueError) as got:
            pt_backends.make_backend(name)
        with pytest.raises(ValueError) as want:
            ref_backends.make_backend(name)
        assert str(got.value) == str(want.value)
        assert "unknown simulator backend" in str(got.value)


def test_register_backend_shadows():
    @pt_backends.register_backend("_test_shadow")
    class Fake:
        name = "_test_shadow"

        def make_cluster(self, profile, n_instances, **kw):
            return "fake"

        def make_pool(self, n_episodes, **kw):
            return "fake-pool"
    try:
        assert pt_backends.make_backend("_test_shadow").make_pool(1) == \
            "fake-pool"
        assert "_test_shadow" in pt_backends.available_backends()
        assert Cluster(PROF, 2, backend="_test_shadow") == "fake"
    finally:
        pt_backends._REGISTRY.pop("_test_shadow", None)


@pytest.mark.parametrize("call", [
    lambda b: b.make_backend("py").make_pool(2),
    lambda b: b.make_backend("engine").make_pool(2),
    lambda b: b.make_backend("engine").make_cluster(None, 2)],
    ids=["py-pool", "engine-pool", "engine-cluster"])
def test_pool_less_backends_keep_the_reference_errors(call):
    with pytest.raises(ValueError) as got:
        call(pt_backends)
    with pytest.raises(ValueError) as want:
        call(ref_backends)
    assert str(got.value) == str(want.value)


def test_jax_backend_builds_the_device_resident_pool():
    """``make_backend("jax")`` builds the port's ``JaxSimPool`` on the
    device asked for; ``RoutingEnv`` steps over one through the registry;
    the default device is the card, which raises without one."""
    backend = pt_backends.make_backend("jax")
    pool = backend.make_pool(3, device="cpu", min_span_ticks=0)
    assert type(pool) is JaxSimPool and pool.E == 3
    assert pool.device.type == "cpu" and pool.min_span_ticks == 0
    cluster = backend.make_cluster(PROF, 2, device="cpu",
                                   scheduler="bin_packing")
    assert isinstance(cluster, VecCluster) and cluster.m == 2
    assert type(cluster.pool) is JaxSimPool
    assert cluster.pool.min_span_ticks == 8
    env = rl.RoutingEnv(rl.RouterConfig(n_instances=2, seed=0), PROF,
                        pool=pool, pool_ep=2)
    env.reset(to_requests(generate(6, seed=1), rate=20.0, seed=2))
    done = False
    while not done:
        _, _, done, _ = env.step(0)
    assert len(env.cluster.completed) == 6
    if not torch.cuda.is_available():
        for call in (lambda: backend.make_pool(2),
                     lambda: backend.make_cluster(PROF, 2),
                     lambda: Cluster(PROF, 2, backend="jax")):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()


def test_cluster_kwarg_dispatches_through_registry():
    assert type(Cluster(PROF, 2)) is Cluster
    cv = Cluster(PROF, 2, backend="vec")
    assert isinstance(cv, VecCluster) and cv.m == 2
    assert type(cv.pool) is VecSimPool
    assert type(pt_backends.make_backend("py").make_cluster(
        PROF, 2, backend="ignored")) is Cluster
    pool = pt_backends.make_backend("vec").make_pool(3)
    assert type(pool) is VecSimPool and pool.E == 3


def test_gateway_backend_resolves_through_registry():
    gw = Gateway(GatewayConfig(backend="vec"), (PROF,) * 2,
                 make_gateway_policy("jsq"))
    assert isinstance(gw.cluster, VecCluster)
    gcfg = GatewayConfig(backend="jax", scheduler="least_work_left")
    gw = Gateway(gcfg, (PROF,) * 2, make_gateway_policy("jsq"),
                 cluster=simulator_cluster(gcfg, (PROF,) * 2,
                                           device="cpu"))
    assert type(gw.cluster.pool) is JaxSimPool
    assert gw.cluster.m == 2
    assert list(gw.cluster.pool.sched[gw.cluster.lane_ids]) == [2, 2]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Gateway(gcfg, (PROF,) * 2, make_gateway_policy("jsq"))


def test_cli_backend_flags_resolve_through_registry():
    parse = serve.build_parser().parse_args
    assert serve._resolve_backend(parse(["--backend", "vec"])) == "vec"
    assert serve._resolve_backend(parse([])) == "py"
    with pytest.warns(DeprecationWarning, match="--sim-backend"):
        assert serve._resolve_backend(parse(["--sim-backend", "vec"])) == \
            "vec"


# -- deprecation shims -------------------------------------------------------

def test_batched_config_sim_backend_shim():
    with pytest.warns(DeprecationWarning, match="sim_backend is"):
        bcfg = batched_rl.BatchedRLConfig(n_envs=2, sim_backend="vec")
    assert bcfg.backend == "vec"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        bcfg = batched_rl.BatchedRLConfig(n_envs=2, backend="vec")
    assert bcfg.backend == "vec"


def test_routing_env_sim_backend_shim():
    cfg = rl.RouterConfig(n_instances=2, seed=0)
    with pytest.warns(DeprecationWarning, match="sim_backend"):
        env = rl.RoutingEnv(cfg, PROF, sim_backend="vec")
    assert env.sim_backend == "vec"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        env = rl.RoutingEnv(cfg, PROF, backend="vec")
    assert env.sim_backend == "vec"
    env.reset(to_requests(generate(5, seed=1), rate=20.0, seed=2))
    assert isinstance(env.cluster, VecCluster)


def test_evaluate_scenarios_sim_backend_shim():
    cfg = rl.RouterConfig(variant="guided", n_instances=2,
                          q_arch="decomposed", seed=0)
    agent = rl.make_agent(cfg, device="cpu")
    reqs = to_requests(generate(12, seed=1), rate=20.0, seed=2)
    scn = Scenario.homogeneous(PROF, 2, reqs)
    with pytest.warns(DeprecationWarning, match="sim_backend"):
        out = batched_rl.evaluate_scenarios(cfg, agent, [scn],
                                            sim_backend="vec")
    assert out[0]["n"] == 12
