"""A real LLM-instance engine on PyTorch (twin of
``repro.serving.engine``): slot-based continuous batching over the port's
model, with a virtual clock driven by the calibrated hardware profile.

One ``LLMInstance`` = one model replica.  It owns
  * a batch-1 prefill written straight into a free slot of the cache
    (K/V, MLA latents, the dense first layer's K/V, conv/ssm states),
    and a gang decode step over every slot (self-attention and the
    mamba prefill's selective scan through the hand-written CUDA kernels
    on the card; MLA and MoE in plain PyTorch, as the reference's are
    plain jnp),
  * a local admission queue ordered by an instance-level scheduler
    (FCFS / bin-packing / least-work-left),
  * a paged-token capacity budget with preemption (newest-first eviction,
    as in vLLM) when decode growth overflows the budget,
  * per-request lifecycle metrics (TTFT / TBT / E2E) on the virtual clock.

The scheduling, clock and bookkeeping code is the reference's, line for
line, so the virtual-clock stamps of the two engines are equal exactly;
only the model calls differ.  Where the reference jits and donates cache
buffers, this engine updates its cache tensors in place.
"""
from __future__ import annotations

import functools
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import resolve_device
from repro_torch.core.prefix_cache import PrefixCache
from repro_torch.core.profiles import HardwareProfile
from repro_torch.models import model as model_lib
from repro_torch.serving import trace as _trace
from repro_torch.serving.request import Phase, Request
from repro_torch.serving.scheduler import InstanceScheduler


class LLMInstance:
    def __init__(self, cfg: ModelConfig, params, profile: HardwareProfile,
                 scheduler: InstanceScheduler, n_slots: int = 8,
                 cache_len: int = 256, instance_id: int = 0,
                 prefix_cache_tokens: int = 0, prefix_block: int = 32,
                 device="cuda"):
        assert cfg.input_mode == "tokens", "engine path uses token inputs"
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {self.device}")
        self.cfg, self.params, self.profile = cfg, params, profile
        self.scheduler = scheduler
        self.n_slots, self.cache_len = n_slots, cache_len
        self.instance_id = instance_id
        self.prefill_fn = functools.partial(model_lib.prefill, cfg=cfg)
        self.decode_fn = functools.partial(model_lib.decode_step, cfg=cfg)
        self.cache = model_lib.init_cache(cfg, n_slots, cache_len,
                                          device=self.device)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.next_tokens = np.zeros((n_slots,), np.int32)
        self.queue: deque = deque()
        self.clock = 0.0
        self.completed: List[Request] = []
        self.failed = False
        # model passes actually run (admissions incl. re-admissions after
        # preemption, and gang decode iterations)
        self.n_prefills = 0
        self.n_decode_steps = 0
        # straggler model: scales every virtual-clock iteration time
        # (1.0 = nominal), same semantics as SimInstance.speed_factor
        self.speed_factor = 1.0
        # prefix/KV cache model (core.prefix_cache): the real prefill
        # still runs in full, but the VIRTUAL clock charges only the
        # uncached suffix, as in the reference engine.
        self.prefix_cache = (PrefixCache(prefix_cache_tokens,
                                         prefix_block)
                             if prefix_cache_tokens > 0 else None)
        # lifecycle tracing (serving.trace).  The virtual clock is
        # advanced BEFORE the decode pass (see step()), so first-token
        # and completion stamps land at the iteration's END.
        self.trace = _trace.NULL
        self.trace_instance = instance_id

    # -- router-visible state ----------------------------------------------
    @property
    def resident(self) -> List[Request]:
        return [r for r in self.slots if r is not None]

    def resident_tokens(self) -> int:
        return sum(r.total_context for r in self.resident)

    def free_tokens(self) -> int:
        return self.profile.capacity_tokens - self.resident_tokens() \
            - sum(r.prompt_tokens + r.decoded for r in self.queue)

    def load_summary(self) -> Dict:
        res = self.resident
        return {
            "n_resident": len(res),
            "n_queued": len(self.queue),
            "p_tokens": [r.prompt_tokens for r in res],
            "d_tokens": [r.decoded for r in res],
            "resident_tokens": self.resident_tokens(),
            "free_tokens": self.free_tokens(),
            "clock": self.clock,
        }

    # -- request intake ------------------------------------------------------
    def submit(self, req: Request):
        req.phase = Phase.INSTANCE_QUEUE
        req.instance = self.instance_id
        req.routed_at = self.clock
        self.queue.append(req)

    # -- one engine iteration -------------------------------------------------
    def step(self) -> List[Request]:
        """Admit + prefill (at most one request/iteration, vLLM-style) then
        gang-decode every active slot.  Returns requests completed at this
        iteration; advances the virtual clock."""
        with _trace.span("repro.engine.step"):
            return self._step()

    def _step(self) -> List[Request]:
        if self.failed:
            return []
        prefill_tokens = 0
        free_slot = next((i for i, s in enumerate(self.slots) if s is None),
                         None)
        if free_slot is not None and self.queue:
            budget = self.profile.capacity_tokens - self.resident_tokens()
            pick = self.scheduler.pick(list(self.queue), budget,
                                       self.profile)
            if pick is not None:
                req = self.queue[pick]
                del self.queue[pick]
                self._admit(req, free_slot)
                cached = 0
                if self.prefix_cache is not None and req.prefix_hashes:
                    cached = self.prefix_cache.admit(req.prompt_tokens,
                                                     req.prefix_hashes)
                    req.cached_prefix = cached
                prefill_tokens += req.prompt_tokens - cached
                if self.trace.enabled:
                    self.trace.emit(self.clock, _trace.EV_INST_ADMIT,
                                    req.rid, self.trace_instance,
                                    req.tenant, {"cached": int(cached)})
                    self.trace.emit(self.clock, _trace.EV_PREFILL_DONE,
                                    req.rid, self.trace_instance,
                                    req.tenant)
        # charge the iteration BEFORE running the decode pass (same anchor
        # as the reference engine and the simulator)
        resident_other = max(self.resident_tokens() - prefill_tokens, 0)
        self.clock += self.profile.iteration_time(
            prefill_tokens, resident_other) * self.speed_factor
        completions = self._decode_iteration()
        # capacity enforcement: evict newest-admitted if over budget
        while (self.resident_tokens() > self.profile.capacity_tokens
               and len(self.resident) > 1):
            self._preempt_newest()
        return completions

    def _admit(self, req: Request, slot: int):
        toks = req.tokens
        if toks is None:
            # the reference's prompt stream: the same rid gives the same
            # prompt in both engines
            rng = np.random.default_rng(req.rid)
            toks = rng.integers(0, self.cfg.vocab_size,
                                size=(req.prompt_tokens,))
        with _trace.span("repro.engine.prefill"):
            toks = torch.as_tensor(np.asarray(toks, np.int64)[None, :],
                                   device=self.device)
            with torch.no_grad():
                logits, self.cache = self.prefill_fn(
                    self.params, tokens=toks, cache=self.cache, slot=slot)
            first = torch.argmax(logits[0])
            with _trace.sync("first_token"):
                self.next_tokens[slot] = int(first)
        self.n_prefills += 1
        self.slots[slot] = req
        req.phase = Phase.DECODE
        req.prefilled = req.prompt_tokens
        req.prefill_done = self.clock

    def _decode_iteration(self) -> List[Request]:
        active = [i for i, r in enumerate(self.slots) if r is not None]
        done: List[Request] = []
        if not active:
            return done
        with _trace.span("repro.engine.decode"):
            toks = torch.as_tensor(self.next_tokens.astype(np.int64),
                                   device=self.device)
            with torch.no_grad():
                logits, self.cache = self.decode_fn(self.params,
                                                    cache=self.cache,
                                                    tokens=toks)
            # one device->host copy per step, not one per slot
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            with _trace.sync("next_tokens"):
                nxt = nxt.cpu().numpy()
        self.n_decode_steps += 1
        tr = self.trace
        for i in active:
            r = self.slots[i]
            r.decoded += 1
            if r.first_token is None:
                r.first_token = self.clock
                if tr.enabled:
                    tr.emit(self.clock, _trace.EV_FIRST_TOKEN, r.rid,
                            self.trace_instance, r.tenant)
            r.token_times.append(self.clock)
            self.next_tokens[i] = nxt[i]
            if r.decoded >= r.decode_tokens:
                r.phase = Phase.DONE
                r.finished = self.clock
                if tr.enabled:
                    tr.emit(self.clock, _trace.EV_COMPLETE, r.rid,
                            self.trace_instance, r.tenant)
                if self.prefix_cache is not None and r.full_hashes:
                    self.prefix_cache.insert(r.full_hashes)
                self.completed.append(r)
                self.slots[i] = None
                done.append(r)
        return done

    def _preempt_newest(self):
        cands = [(r.prefill_done or 0.0, i) for i, r in
                 enumerate(self.slots) if r is not None]
        if len(cands) <= 1:     # never evict the last resident (liveness)
            return
        _, i = max(cands)
        req = self.slots[i]
        self.slots[i] = None
        if self.trace.enabled:
            self.trace.emit(self.clock, _trace.EV_PREEMPT, req.rid,
                            self.trace_instance, req.tenant,
                            {"lost": int(req.prefilled + req.decoded)})
        req.reset_progress()
        self.queue.appendleft(req)

    # -- fault injection (cluster manager) -----------------------------------
    def fail(self) -> List[Request]:
        """Kill the instance; return in-flight + queued requests for
        re-routing (idempotent: their progress is reset)."""
        self.failed = True
        if self.trace.enabled:
            self.trace.emit(self.clock, _trace.EV_FAIL, -1,
                            self.trace_instance)
        orphans = [r for r in self.slots if r is not None] + list(self.queue)
        self.slots = [None] * self.n_slots
        self.queue.clear()
        if self.prefix_cache is not None:
            self.prefix_cache.clear()
        for r in orphans:
            r.reset_progress()
            r.phase = Phase.QUEUED
            r.instance = None
            # the attempt died: clear timing stamps so TTFT/TBT/E2E
            # measure the attempt that actually serves the request
            r.first_token = None
            r.token_times = []
            r.prefill_done = None
        return orphans

    def recover(self):
        """Undo :meth:`fail`: the instance comes back empty (cold KV)
        at its current clock and resumes accepting work."""
        self.failed = False
        if self.trace.enabled:
            self.trace.emit(self.clock, _trace.EV_RECOVER, -1,
                            self.trace_instance)

    def steal(self, req: Request) -> bool:
        """Withdraw a routed request for hedged re-dispatch; returns
        False if it is no longer here (completed this step)."""
        if req in self.queue:
            self.queue.remove(req)
        else:
            slot = next((i for i, r in enumerate(self.slots)
                         if r is req), None)
            if slot is None:
                return False
            self.slots[slot] = None
        req.reset_progress()
        req.phase = Phase.QUEUED
        req.instance = None
        req.first_token = None
        req.token_times = []
        req.prefill_done = None
        return True
