"""What the harness asks of the program under test (``repro_torch``):
its objects built as ``launch/serve.py::serve_gateway`` builds them on
its ``--backend engine --policy rl`` path.  Nothing here computes a
metric or decides ``correct``."""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import get_config
from repro_torch.core import rl_router as rl
from repro_torch.core.profiles import HardwareProfile
from repro_torch.serving.request import Request

from pbench.traffic import Item


def profile(config: Dict) -> HardwareProfile:
    """The cell's fixed profile (never calibrated at set-up)."""
    return HardwareProfile(**config["profile"])


def router_cfg(n_instances: int) -> rl.RouterConfig:
    """``serve_gateway``'s router configuration (``_router_cfg`` at its
    defaults: no prefix cache, no online learner, 8 training episodes)."""
    return rl.RouterConfig(variant="guided", n_instances=n_instances,
                           q_arch="decomposed", seed=0,
                           explore_episodes=5, scheduler="fcfs")


def _check(want: Dict, got, path: str) -> List[str]:
    bad = []
    for key, val in want.items():
        have = getattr(got, key)
        if isinstance(val, dict):
            bad += _check(val, have, f"{path}{key}.")
        elif have != val:
            bad.append(f"{path}{key}: program {have!r}, file {val!r}")
    return bad


def model_config(config: Dict):
    """The program's ModelConfig for ``config``, held to the file's
    published sizes.  A file with a ``tiny`` key (the tests' cells on
    the CPU) takes the program's ``reduced()`` config with those
    overrides, and is held to its own sizes the same way."""
    cfg = get_config(config["name"])
    if "tiny" in config:
        tiny = dict(config["tiny"])
        for group in ("moe", "mamba"):
            if group in tiny:
                tiny[group] = dataclasses.replace(
                    getattr(cfg.reduced(), group), **tiny[group])
        cfg = cfg.reduced(**tiny)
    bad = _check(config["model"], cfg, "")
    if bad:
        raise SystemExit("the program's config departs from the file: "
                         + "; ".join(bad))
    return cfg


def requests(items: List[Item], tenant: str = "bench") -> List[Request]:
    return [Request(prompt_tokens=it.prompt_tokens,
                    decode_tokens=it.decode_tokens, arrival=it.arrival,
                    task=it.component, tenant=tenant, tokens=it.tokens)
            for it in items]

