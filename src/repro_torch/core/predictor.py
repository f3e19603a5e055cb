"""Output-length (decode-bucket) predictor (paper §5.1), in PyTorch.

A small transformer encoder classifies an input prompt into a decode
bucket.  Faithful elements of the paper's design:

  * buckets are TIME-ALIGNED and unequal (0.5 * 4^k second boundaries
    mapped to token counts via the hardware profile) rather than equal
    token ranges;
  * the task type is appended as a HINT token to the prompt
    ("This is a <task> task"), which is what lifts accuracy from
    near-chance (S^3-style, 5.5% in the paper) to useful levels;
  * a task classifier (same encoder, task labels) shows the task itself is
    recoverable from content (paper §A.7: 93.79%), justifying the hint.

A feature-based variant (prompt length + app id -> bucket) reproduces the
§A.12 production-trace predictor where prompt content is unavailable.

The port of ``repro.core.predictor``.  The encoder's attention is plain
``einsum``/softmax in the reference, outside any Pallas kernel, so it is
plain torch here; its conventions are the reference's (tanh GELU, the
population variance, norms scaled by ``1 + w``, ``-1e30`` masks).
Weights are initialised from a ``torch.Generator`` (``jax.random``
cannot be reproduced in torch); ``from_reference`` carries the
reference's trees over by value.  Everything drawn with numpy (samples,
epoch order) uses the reference's ``np.random.default_rng`` streams.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.common.device import resolve_device
from repro_torch.core import workload as wl
from repro_torch.core.dqn import adam_step, zeros_opt
from repro_torch.core.profiles import HardwareProfile


@dataclass(frozen=True)
class PredictorConfig:
    vocab: int = wl.VOCAB + len(wl.TASKS) + 1   # + hint tokens + pad
    seq_len: int = 64
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    n_buckets: int = 8
    use_hint: bool = True
    lr: float = 3e-4
    batch: int = 128


def _pad_token(cfg: PredictorConfig) -> int:
    return cfg.vocab - 1


def hint_token(cfg: PredictorConfig, task_id: int) -> int:
    return wl.VOCAB + task_id


def encode_sample(cfg: PredictorConfig, s: wl.Sample) -> np.ndarray:
    toks = list(s.token_ids[:cfg.seq_len - 1])
    if cfg.use_hint:
        toks.append(hint_token(cfg, s.task_id))   # "This is a <task> task"
    toks = toks[:cfg.seq_len]
    toks += [_pad_token(cfg)] * (cfg.seq_len - len(toks))
    return np.asarray(toks, np.int32)


def _norm(x, w):
    mu = torch.mean(x, -1, keepdim=True)
    var = torch.var(x, -1, keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + 1e-6) * (1 + w)


class _Layer(nn.Module):
    def __init__(self, d: int, dense, device):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = (
            nn.Parameter(dense(d, d)) for _ in range(4))
        self.w1 = nn.Parameter(dense(d, 4 * d))
        self.w2 = nn.Parameter(dense(4 * d, d))
        self.ln1 = nn.Parameter(torch.zeros((d,), device=device))
        self.ln2 = nn.Parameter(torch.zeros((d,), device=device))


class Encoder(nn.Module):
    """tokens [B, L] -> logits [B, n_out] (the reference's ``apply``);
    parameters named as the reference's tree (``embed``, ``head``,
    ``layers.{i}.wq`` ...)."""

    def __init__(self, cfg: PredictorConfig, n_out: int,
                 generator: torch.Generator, device):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model

        def dense(*sh):
            return torch.randn(sh, generator=generator,
                               device=device) / math.sqrt(sh[0])
        self.embed = nn.Parameter(dense(cfg.vocab, d) * math.sqrt(d) / d)
        self.head = nn.Parameter(dense(d, n_out))
        self.layers = nn.ModuleList(_Layer(d, dense, device)
                                    for _ in range(cfg.n_layers))
        pos = torch.arange(cfg.seq_len, device=device)
        self.register_buffer("pos_term", 0.02 * torch.sin(
            pos[:, None] * torch.exp(
                -torch.arange(d, device=device)[None, :] / d * 6.0)),
            persistent=False)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = tokens != _pad_token(cfg)
        b, n = tokens.shape
        h = cfg.n_heads
        hd = cfg.d_model // h
        x = self.embed[tokens] + self.pos_term
        keep = mask[:, None, None, :]
        for lp in self.layers:
            hx = _norm(x, lp.ln1)
            q = (hx @ lp.wq).reshape(b, n, h, hd)
            k = (hx @ lp.wk).reshape(b, n, h, hd)
            v = (hx @ lp.wv).reshape(b, n, h, hd)
            sc = torch.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(hd)
            sc = torch.where(keep, sc, torch.full_like(sc, -1e30))
            w = torch.softmax(sc, -1)
            o = torch.einsum("bhqs,bshk->bqhk", w, v).reshape(hx.shape)
            x = x + o @ lp.wo
            hx = _norm(x, lp.ln2)
            x = x + F.gelu(hx @ lp.w1, approximate="tanh") @ lp.w2
        pooled = torch.sum(x * mask[..., None], 1) / torch.clamp(
            torch.sum(mask, 1, keepdim=True), min=1)
        return pooled @ self.head

    def reference_tree(self) -> Dict:
        """The parameters as the reference's tree of numpy arrays."""
        def arr(p):
            return p.detach().cpu().numpy()
        return {"embed": arr(self.embed), "head": arr(self.head),
                "layers": [{name: arr(p) for name, p
                            in lp.named_parameters()}
                           for lp in self.layers]}

    def load_reference(self, tree: Dict):
        """Copy the reference's parameter tree (``init_params`` /
        ``BucketPredictor.params``, numpy arrays) into this encoder."""
        self.load_state_dict({k: torch.tensor(np.asarray(v, np.float32))
                              for k, v in _flat(tree).items()}, strict=True)


def _flat(tree: Dict) -> Dict:
    """The reference's predictor tree -> torch parameter names."""
    flat = {"embed": tree["embed"], "head": tree["head"]}
    for i, lp in enumerate(tree["layers"]):
        flat.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return flat


def _train_step(params: Encoder, opt: Dict, cfg: PredictorConfig,
                tokens: torch.Tensor, labels: torch.Tensor
                ) -> torch.Tensor:
    """One Adam step on the mean cross-entropy, in place on ``params``
    and ``opt``; returns the loss as a device tensor."""
    logits = params(tokens)
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    with torch.no_grad():
        adam_step(named, grads, opt, cfg.lr)
    return loss.detach()


class BucketPredictor:
    """Trainable decode-bucket predictor over prompt content (+ hint),
    its encoder on ``device`` (the card unless asked otherwise)."""

    def __init__(self, cfg: PredictorConfig, profile: HardwareProfile,
                 seed: int = 0, n_out: Optional[int] = None,
                 equal_buckets: bool = False, device="cuda"):
        self.cfg, self.profile = cfg, profile
        self.equal_buckets = equal_buckets
        self.n_out = n_out or cfg.n_buckets
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = Encoder(cfg, self.n_out, gen, self.device)
        self.opt = zeros_opt(self.params)

    def from_reference(self, params: Dict):
        """Load the reference predictor's ``params`` tree (numpy
        arrays)."""
        self.params.load_reference(params)

    def label(self, s: wl.Sample) -> int:
        if self.equal_buckets:        # S^3-style equal 250-token buckets
            return min(s.decode_tokens // 250, self.n_out - 1)
        return min(self.profile.bucketize(s.decode_tokens,
                                          self.cfg.n_buckets),
                   self.n_out - 1)

    def fit(self, samples: Sequence[wl.Sample], epochs: int = 3,
            seed: int = 0, labels: Optional[Sequence[int]] = None,
            verbose: bool = False) -> List[float]:
        cfg = self.cfg
        x = np.stack([encode_sample(cfg, s) for s in samples])
        y = np.asarray(labels if labels is not None
                       else [self.label(s) for s in samples], np.int64)
        rng = np.random.default_rng(seed)
        losses = []
        for ep in range(epochs):
            order = rng.permutation(len(x))
            for i in range(0, len(x) - cfg.batch + 1, cfg.batch):
                idx = order[i:i + cfg.batch]
                loss = _train_step(
                    self.params, self.opt, cfg,
                    torch.from_numpy(x[idx]).long().to(self.device),
                    torch.from_numpy(y[idx]).to(self.device))
            losses.append(float(loss))
            if verbose:
                print(f"  predictor epoch {ep}: loss {float(loss):.3f}")
        return losses

    def logits(self, samples: Sequence[wl.Sample],
               chunk: int = 512) -> np.ndarray:
        """Float32 logits [n, n_out], chunks PADDED to ``chunk`` rows
        (pad rows are all-pad-token and discarded), so every forward on
        the card has one of a few fixed shapes."""
        cfg = self.cfg
        x = np.stack([encode_sample(cfg, s) for s in samples])
        out = []
        pad_row = np.full((1, cfg.seq_len), _pad_token(cfg), np.int32)
        with torch.no_grad():
            for i in range(0, len(x), chunk):
                part = x[i:i + chunk]
                n = len(part)
                if n < chunk:
                    part = np.concatenate(
                        [part, np.repeat(pad_row, chunk - n, axis=0)])
                tok = torch.from_numpy(part).long().to(self.device)
                out.append(self.params(tok)[:n].cpu().numpy())
        return np.concatenate(out)

    def predict(self, samples: Sequence[wl.Sample],
                chunk: int = 512) -> np.ndarray:
        """Batched greedy prediction over padded chunks."""
        return np.argmax(self.logits(samples, chunk), -1)

    def accuracy(self, samples: Sequence[wl.Sample],
                 labels: Optional[Sequence[int]] = None) -> float:
        y = np.asarray(labels if labels is not None
                       else [self.label(s) for s in samples])
        return float(np.mean(self.predict(samples) == y))

    def bucket_upper_tokens(self, bucket: int) -> int:
        edges = self.profile.bucket_edges(self.cfg.n_buckets)
        if bucket >= len(edges):
            return int(edges[-1] * 2)
        return int(edges[bucket])

    def bucket_of(self, decode_tokens: int) -> int:
        """The bucket an ACTUAL decode length lands in -- label() over
        a realized length instead of a Sample (predictor-drift
        bucket-accuracy in StreamMetrics)."""
        if self.equal_buckets:
            return min(decode_tokens // 250, self.n_out - 1)
        return min(self.profile.bucketize(decode_tokens,
                                          self.cfg.n_buckets),
                   self.n_out - 1)

    def decode_estimate(self, samples: Sequence[wl.Sample]) -> np.ndarray:
        """d-hat per sample = upper bound of the predicted bucket (what the
        router's impact estimator consumes)."""
        return np.array([self.bucket_upper_tokens(b)
                         for b in self.predict(samples)])


class TaskClassifier(BucketPredictor):
    """§A.7: predict the task from content alone (no hint)."""

    def __init__(self, profile, seed: int = 0, device="cuda"):
        cfg = PredictorConfig(use_hint=False)
        super().__init__(cfg, profile, seed, n_out=len(wl.TASKS),
                         device=device)

    def label(self, s: wl.Sample) -> int:
        return s.task_id


# -- router-facing d-hat plumbing (predictor in the routing loop) -----------

def serviceable_decode(profile: HardwareProfile, d_hat: int,
                       prompt_tokens: int) -> int:
    """Clamp a decode estimate to the instance-serviceable KV budget
    (vLLM-style max-tokens bound): a top-bucket upper edge can exceed
    the whole pool, and an unserviceable d-hat would make the router's
    capacity-fit check defer the request forever.  ONE definition,
    shared by training-time annotation and the serving gateway, so the
    router trains on exactly the signal it serves with."""
    cap = int(profile.capacity_tokens * 0.95)
    return max(min(int(d_hat), cap - prompt_tokens), 1)


def annotate_requests(predictor: "BucketPredictor", requests,
                      samples) -> None:
    """Batch-predict decode buckets for ``samples`` (one padded forward
    per 512) and stamp the aligned ``requests`` with
    ``predicted_bucket`` / ``predicted_decode`` -- the d-hat the state
    featurizer, the impact estimator, and the backlog penalty consume
    instead of the oracle length."""
    if not requests:
        return
    buckets = predictor.predict(samples)
    for r, b in zip(requests, buckets):
        r.predicted_bucket = int(b)
        r.predicted_decode = serviceable_decode(
            predictor.profile, predictor.bucket_upper_tokens(int(b)),
            r.prompt_tokens)


def predicted_decode(req) -> int:
    """``predict_decode`` hook reading the stamped d-hat (oracle
    fallback for requests that never passed the predictor)."""
    d = req.predicted_decode
    return d if d is not None else req.decode_tokens


def annotating_stream(scenario_fn, predictor: "BucketPredictor"):
    """Wrap a scenario stream so every episode's requests are stamped
    with predictor d-hats before training sees them (pass
    ``predict_decode=predicted_decode`` alongside)."""
    def fn(ep: int):
        scn = scenario_fn(ep)
        if scn.samples is not None:
            annotate_requests(predictor, scn.requests, scn.samples)
        return scn
    return fn


def quick_bucket_predictor(profile: HardwareProfile,
                           n_train: int = 2000, epochs: int = 2,
                           seed: int = 0,
                           cfg: Optional[PredictorConfig] = None,
                           device="cuda") -> "BucketPredictor":
    """Train a small bucket predictor on fresh synthetic samples --
    the shared setup step for the gateway launcher and the
    predictor-in-the-loop trainer."""
    cfg = cfg or PredictorConfig()
    pred = BucketPredictor(cfg, profile, seed=seed, device=device)
    pred.fit(wl.generate(n_train, seed=seed + 1), epochs=epochs,
             seed=seed + 2)
    return pred


# -- §A.12 trace predictor (no prompt content) ------------------------------

class TracePredictor:
    """(log prompt_len, app one-hot) -> bucket, tiny MLP (random-forest
    stand-in; sklearn is unavailable offline)."""

    def __init__(self, profile: HardwareProfile, n_apps: int,
                 n_buckets: int = 8, seed: int = 0, device="cuda"):
        self.profile, self.n_buckets = profile, n_buckets
        self.n_apps = n_apps
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        d_in = 2 + n_apps
        self.w1 = torch.randn((d_in, 64), generator=gen,
                              device=self.device) / math.sqrt(d_in)
        self.b1 = torch.zeros((64,), device=self.device)
        self.w2 = torch.randn((64, n_buckets), generator=gen,
                              device=self.device) / math.sqrt(64)
        self.b2 = torch.zeros((n_buckets,), device=self.device)

    def from_reference(self, w1, b1, w2, b2):
        """Load the reference predictor's weights (numpy arrays)."""
        self.w1, self.b1, self.w2, self.b2 = (
            torch.tensor(np.asarray(a, np.float32), device=self.device)
            for a in (w1, b1, w2, b2))

    def _feats(self, samples):
        f = np.zeros((len(samples), 2 + self.n_apps), np.float32)
        for i, s in enumerate(samples):
            f[i, 0] = np.log1p(s.prompt_tokens) / 10.0
            f[i, 1] = (s.prompt_tokens % 997) / 997.0
            f[i, 2 + s.task_id % self.n_apps] = 1.0
        return torch.from_numpy(f).to(self.device)

    def _labels(self, samples) -> np.ndarray:
        return np.asarray([min(self.profile.bucketize(s.decode_tokens,
                                                      self.n_buckets),
                               self.n_buckets - 1) for s in samples])

    def _logits(self, x, w1, b1, w2, b2):
        return torch.relu(x @ w1 + b1) @ w2 + b2

    def fit(self, samples, epochs: int = 60, lr: float = 1e-2,
            seed: int = 0):
        x = self._feats(samples)
        y = torch.from_numpy(self._labels(samples)).to(self.device)
        params = [p.clone().requires_grad_(True)
                  for p in (self.w1, self.b1, self.w2, self.b2)]
        for _ in range(epochs):
            logits = self._logits(x, *params)
            logz = torch.logsumexp(logits, -1)
            gold = logits.gather(1, y[:, None])[:, 0]
            grads = torch.autograd.grad(torch.mean(logz - gold), params)
            with torch.no_grad():
                params = [(p - lr * g).requires_grad_(True)
                          for p, g in zip(params, grads)]
        self.w1, self.b1, self.w2, self.b2 = (p.detach() for p in params)

    def predict(self, samples) -> np.ndarray:
        with torch.no_grad():
            logits = self._logits(self._feats(samples), self.w1, self.b1,
                                  self.w2, self.b2)
        return torch.argmax(logits, -1).cpu().numpy()

    def accuracy(self, samples) -> float:
        return float(np.mean(self.predict(samples)
                             == self._labels(samples)))
