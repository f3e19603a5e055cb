"""Fault-tolerant serving cluster manager.

Glues the intelligent router to a cluster (simulated or real engines):
  * heartbeat-based failure detection -> orphaned requests are re-queued
    at the router (idempotent ids, progress reset) and the dead instance is
    masked out of the action space;
  * elastic scale-out/in: instances can be added/removed at runtime.  With
    the decomposed Q network the SAME router weights score any instance
    count (the paper's fixed-m MLP requires retraining -- §A.11 had to
    grow the network for 8 instances);
  * router-state checkpointing (the DQN's networks and optimizer)
    through training.checkpoint for restart;
  * straggler mitigation: per-instance EWMA of observed iteration time
    feeds a slowdown factor into the capacity feature, so the router
    steers work away from degraded instances.

The port's copy of ``repro.core.cluster_manager``, over the ``py``
simulator stepper; the agent's networks live on its own device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import rl_router, state as state_lib
from repro_torch.core.dqn import DQNAgent
from repro_torch.core.profiles import HardwareProfile
from repro_torch.serving.request import Request, summarize
from repro_torch.training.checkpoint import CheckpointManager


@dataclass
class ManagedClusterConfig:
    n_instances: int = 4
    heartbeat_timeout: float = 1.0      # simulated-seconds between beats
    straggler_ewma: float = 0.2
    straggler_threshold: float = 2.0    # x median iteration time
    checkpoint_dir: Optional[str] = None


class ManagedCluster:
    def __init__(self, cfg: ManagedClusterConfig,
                 router_cfg: rl_router.RouterConfig,
                 profile: HardwareProfile, agent: DQNAgent):
        self.cfg = cfg
        self.router_cfg = router_cfg
        self.profile = profile
        self.agent = agent
        self.env = rl_router.RoutingEnv(router_cfg, profile)
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir else None)
        self.events: List[str] = []

    # -- failure / elasticity hooks -----------------------------------------
    def fail_instance(self, idx: int):
        self.env.cluster.fail_instance(idx)
        self.events.append(f"t={self.env.cluster.t:.2f} FAIL instance {idx}")

    def restore_instance(self, idx: int):
        inst = self.env.cluster.instances[idx]
        inst.restore()
        inst.clock = self.env.cluster.t
        self.events.append(f"t={self.env.cluster.t:.2f} RESTORE {idx}")

    def add_instance(self) -> int:
        i = self.env.cluster.add_instance(self.router_cfg.scheduler,
                                          self.router_cfg.chunked_prefill)
        self.events.append(f"t={self.env.cluster.t:.2f} ADD instance {i}")
        return i

    # -- checkpoint / restart ----------------------------------------------
    def save_router(self, step: int):
        if self.ckpt:
            self.ckpt.save(step, self.agent.state_dict(), sync=True)

    def restore_router(self) -> bool:
        if not self.ckpt:
            return False
        out = self.ckpt.restore(self.agent.state_dict())
        if out is None:
            return False
        self.agent.load_state_dict(out[0])
        return True

    def close(self):
        """Stop the checkpoint writer thread (after pending saves)."""
        if self.ckpt:
            self.ckpt.close()

    # -- serving loop ------------------------------------------------------
    def serve(self, requests: Sequence[Request],
              fault_plan: Optional[Dict[float, str]] = None) -> Dict:
        """Run an episode; fault_plan maps sim-time -> event string
        ("fail:<i>" | "restore:<i>" | "add")."""
        fault_plan = dict(fault_plan or {})
        env = self.env
        s = env.reset(requests)
        cfg = self.router_cfg
        w_sel = cfg.guidance_floor if cfg.variant == "guided" else 0.0
        done = False
        while not done:
            for t_evt in sorted(list(fault_plan)):
                if env.cluster.t >= t_evt:
                    evt = fault_plan.pop(t_evt)
                    kind, _, arg = evt.partition(":")
                    if kind == "fail":
                        self.fail_instance(int(arg))
                    elif kind == "restore":
                        self.restore_instance(int(arg))
                    elif kind == "add":
                        self.add_instance()
            mask = state_lib.action_mask(env.cluster)
            prior = w_sel * env.guidance_bonus() if w_sel else None
            if (self.agent.cfg.q_arch == "decomposed"
                    or env.cluster.m + 1 == self.agent.cfg.n_actions):
                s = env._state()
                a = self.agent.act(s, mask, epsilon=0.0, prior=prior,
                                   q_squash=cfg.q_squash if w_sel else 0.0)
            else:
                # fixed-m MLP cannot score a resized cluster: fall back to
                # the guidance heuristic
                bonus = env.guidance_bonus()
                bonus[~mask] = -np.inf
                a = int(np.argmax(bonus))
            _, _, done, _ = env.step(a)
        stats = summarize(requests)
        stats["events"] = list(self.events)
        stats["preemptions"] = sum(r.preemptions for r in requests)
        return stats
