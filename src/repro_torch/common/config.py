"""Configuration dataclasses for the repro framework.

Every assigned architecture is expressed as a ``ModelConfig``.  Configs are
plain frozen dataclasses (hashable -> usable as jit static args).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block configuration (routed + optional shared)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # shared (always-on) experts, deepseek-style
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    impl: str = "ragged"     # "dense" | "ragged" | "ep" (EP shard_map)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2 / MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MambaConfig:
    """Mamba-1 selective SSM block configuration."""

    d_inner: int
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 256              # chunked-scan chunk length


@dataclass(frozen=True)
class ModelConfig:
    """A decoder-only LM backbone (covers all 10 assigned archs)."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # layer pattern: repeated period of layer kinds
    # ("attn" | "mamba" | "cross").
    layer_pattern: Tuple[str, ...] = ("attn",)
    # which positions in the period use MoE instead of a dense FFN
    moe_pattern: Tuple[bool, ...] = (False,)
    activation: str = "silu"      # silu | gelu | relu
    gated_mlp: bool = True        # GLU-style gate (GeGLU / SwiGLU)
    attention: str = "gqa"        # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    logit_softcap: float = 0.0   # gemma/grok final-logit softcap (0=off)
    scale_embeddings: bool = False  # gemma: multiply embeddings by sqrt(d)
    tie_embeddings: bool = False
    dense_first_layer: bool = False   # deepseek-moe: layer 0 uses a dense FFN
    dense_first_d_ff: int = 0         # hidden dim for that dense first layer
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    # modality frontends (stubs: input_specs() provides precomputed embeddings)
    input_mode: str = "tokens"    # tokens | embeddings (audio stub)
    n_codebooks: int = 0          # musicgen: parallel codebook heads
    vision_tokens: int = 0        # llama-3.2-vision: # of image tokens
    vision_dim: int = 0           # dim of the (stub) vision embeddings
    max_seq_len: int = 32768
    dtype: str = "bfloat16"
    # int8-quantized KV cache (per-token-per-head dynamic scales): halves
    # the decode step's dominant HBM term (beyond-paper serving
    # optimization; §Perf hillclimb 3)
    kv_cache_dtype: str = "bfloat16"      # "bfloat16" | "int8"
    # sub-quadratic? (permits long_500k decode)
    subquadratic: bool = False
    # swap in Pallas kernels (TPU target).  Kept so the configs match the
    # JAX package field for field; the port reads it nowhere: its
    # attention always goes through repro_torch.kernels, which dispatch
    # on the tensor's device.
    use_pallas: bool = False
    remat: bool = True
    # unroll every internal lax.scan (layers, blocked attention, chunked
    # CE, ssm chunks).  Used by the dry-run's shallow analysis compiles:
    # XLA cost_analysis counts a while-loop body ONCE regardless of trip
    # count, so roofline flops are extrapolated from two unrolled
    # shallow-depth compiles instead.
    scan_unroll: bool = False    # activation ckpting on the layer scan

    # ---- derived helpers -------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_periods(self) -> int:
        assert self.n_scan_layers % self.period == 0, (
            f"{self.name}: {self.n_scan_layers} layers not divisible by "
            f"period {self.period}")
        return self.n_scan_layers // self.period

    @property
    def n_scan_layers(self) -> int:
        """Layers inside the scan (excludes a special dense first layer)."""
        return self.n_layers - (1 if self.dense_first_layer else 0)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def dt_rank(self) -> int:
        if self.mamba is None:
            return 0
        return self.mamba.dt_rank or -(-self.d_model // 16)

    def layer_kind(self, pos: int) -> str:
        return self.layer_pattern[pos % self.period]

    def layer_is_moe(self, pos: int) -> bool:
        return self.moe_pattern[pos % self.period]

    def count_params(self) -> int:
        """Analytic parameter count (matches init_params; roofline)."""
        from repro_torch.models.params import count_params
        return count_params(self)

    def count_active_params(self) -> int:
        from repro_torch.models.params import count_params
        return count_params(self, active_only=True)

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        changes = dict(
            n_layers=max(self.period * 2,
                         2 + (1 if self.dense_first_layer else 0)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            d_ff=128,
            vocab_size=512,
            head_dim=16,
            max_seq_len=128,
            dtype="float32",
            remat=False,
        )
        if self.dense_first_layer:
            changes["dense_first_d_ff"] = 128
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2), d_expert=32,
                n_shared=min(self.moe.n_shared, 1), impl="ragged")
        if self.mla is not None:
            changes["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                       qk_nope_head_dim=16, qk_rope_head_dim=8,
                                       v_head_dim=16)
        if self.mamba is not None:
            changes["mamba"] = dataclasses.replace(
                self.mamba, d_inner=128, d_state=8, dt_rank=8, chunk=16)
        if self.vision_tokens:
            changes["vision_tokens"] = 16
            changes["vision_dim"] = 32
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str   # "train" | "prefill" | "decode"


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")
ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """The assigned shape set for an architecture (long_500k only for
    sub-quadratic archs, per the assignment)."""
    if cfg.subquadratic:
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
