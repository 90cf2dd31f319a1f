"""Architecture + shape configuration for the LP framework.

The port's own copy of the JAX package's ``configs/base.py`` (the port
imports nothing of that package). Fields, defaults and ``reduced_config``
are identical, so both packages build the same model from the same name.

Every architecture is expressed as an ``ArchConfig`` built from a
repeating ``LayerSpec`` pattern; the stack assembly
(`repro_torch.model.stack`) groups layers of one signature into segments.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

#: Temporal-mixing kinds understood by the model zoo.
MIXERS = (
    "attn",          # causal full attention (RoPE unless pos_embed overrides)
    "attn_bidir",    # bidirectional attention (whisper encoder)
    "attn_local",    # sliding-window causal attention
    "attn_chunked",  # llama4-style chunked causal attention
    "attn_global",   # causal full attention without RoPE (llama4 NoPE layers)
    "rec",           # RG-LRU recurrent block (recurrentgemma)
    "mamba",         # Mamba-1 selective SSM mixer (whole layer, no separate FFN)
)

FFNS = ("mlp", "moe", None)


@dataclass(frozen=True)
class LayerSpec:
    """One layer position inside the repeating block pattern."""

    mixer: str = "attn"
    ffn: Optional[str] = "mlp"
    cross_attn: bool = False  # decoder cross-attention (whisper)

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # Attention details
    rope_theta: float = 10_000.0
    window: int = 0          # sliding-window size for attn_local
    chunk: int = 0           # chunk size for attn_chunked
    pos_embed: str = "rope"  # rope | learned | none
    max_position: int = 8192  # learned-position table size
    qk_norm: bool = False

    # Block structure
    block_pattern: Tuple[LayerSpec, ...] = (LayerSpec(),)
    mlp_gated: bool = True
    mlp_act: str = "silu"
    norm_kind: str = "rmsnorm"   # rmsnorm | layernorm
    norm_plus_one: bool = False  # gemma-style (1 + scale) RMSNorm
    attn_bias: bool = False
    mlp_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_capacity_factor: float = 1.25
    moe_shared_expert: bool = False

    # SSM (Mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)

    # RG-LRU (recurrentgemma)
    lru_width: int = 0  # 0 -> d_model
    rec_conv: int = 4

    # Encoder-decoder (whisper): encoder depth + frontend-stub sequence length
    enc_layers: int = 0
    enc_seq: int = 1500

    # VLM (paligemma): number of precomputed patch-embedding prefix tokens
    prefix_len: int = 0

    # Sub-quadratic? (decides long_500k applicability)
    subquadratic: bool = False

    notes: str = ""

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))
        if self.dt_rank == 0 and self.family == "ssm":
            object.__setattr__(self, "dt_rank", math.ceil(self.d_model / 16))
        if self.lru_width == 0 and self.family == "hybrid":
            object.__setattr__(self, "lru_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba inner width."""
        return self.ssm_expand * self.d_model

    def layer_specs(self) -> Tuple[LayerSpec, ...]:
        """Expand the repeating pattern to n_layers entries (truncating the
        final repeat when n_layers % len(pattern) != 0, e.g. recurrentgemma)."""
        period = len(self.block_pattern)
        reps = math.ceil(self.n_layers / period)
        return tuple((self.block_pattern * reps)[: self.n_layers])

    def param_count(self, *, active_only: bool = False) -> int:
        """Approximate parameter count (embedding + per-layer), used for the
        6·N·D MODEL_FLOPS roofline term."""
        n = 0
        n += self.vocab_size * self.d_model  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model  # unembedding
        for spec in self.layer_specs():
            n += self._layer_params(spec, active_only=active_only)
        # Encoder stack (whisper): self-attention + MLP, no cross-attention.
        enc_spec = LayerSpec(mixer="attn_bidir", ffn="mlp")
        for _ in range(self.enc_layers):
            n += self._layer_params(enc_spec, active_only=active_only)
        return n

    def _layer_params(self, spec: LayerSpec, *, active_only: bool) -> int:
        d = self.d_model
        n = 0
        if spec.mixer.startswith("attn"):
            q = self.n_heads * self.head_dim * d
            kv = 2 * self.n_kv_heads * self.head_dim * d
            o = self.n_heads * self.head_dim * d
            n += q + kv + o
        elif spec.mixer == "rec":
            w = self.lru_width
            n += 2 * d * w  # in projections (x, gate branch)
            n += w * d      # out projection
            n += self.rec_conv * w + 3 * w  # conv + lru gates
        elif spec.mixer == "mamba":
            di = self.d_inner
            n += d * 2 * di               # in_proj
            n += self.ssm_conv * di       # conv1d
            n += di * (self.dt_rank + 2 * self.ssm_state)  # x_proj
            n += self.dt_rank * di + di   # dt_proj
            n += di * self.ssm_state + di  # A_log, D
            n += di * d                   # out_proj
        if spec.cross_attn:
            q = self.n_heads * self.head_dim * d
            kv = 2 * self.n_kv_heads * self.head_dim * d
            o = self.n_heads * self.head_dim * d
            n += q + kv + o
        if spec.ffn == "mlp":
            mats = 3 if self.mlp_gated else 2
            n += mats * d * self.d_ff
        elif spec.ffn == "moe":
            mats = 3 if self.mlp_gated else 2
            per_expert = mats * d * self.d_ff
            experts = self.moe_top_k if active_only else self.moe_experts
            n += experts * per_expert
            if self.moe_shared_expert:
                n += per_expert
            n += d * self.moe_experts  # router
        return n


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    assert cfg.name not in _REGISTRY, f"duplicate arch {cfg.name}"
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    # Import side-effect registration lazily to avoid cycles.
    from repro_torch import configs as _  # noqa: F401

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _  # noqa: F401

    return sorted(_REGISTRY)


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def reduced_config(cfg: ArchConfig, *, n_layers: int | None = None) -> ArchConfig:
    """Scale an architecture down to CPU-smoke size, preserving its family
    structure (pattern, gating, norm kind, MoE/SSM topology)."""
    period = len(cfg.block_pattern)
    layers = n_layers if n_layers is not None else max(2 * period, 2)
    heads = min(cfg.n_heads, 4) or 4  # attn-free archs (n_heads=0) still need d_model
    kv = max(1, min(cfg.n_kv_heads, heads))
    hd = 16
    d_model = heads * hd * 2
    return replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=4 * d_model if cfg.d_ff else 0,
        vocab_size=512,
        window=min(cfg.window, 16) if cfg.window else 0,
        chunk=min(cfg.chunk, 16) if cfg.chunk else 0,
        max_position=512,
        moe_experts=min(cfg.moe_experts, 4) if cfg.moe_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.moe_top_k else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        dt_rank=8 if cfg.family == "ssm" else 0,
        lru_width=d_model if cfg.family == "hybrid" else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=24 if cfg.enc_layers else 1500,
        prefix_len=8 if cfg.prefix_len else 0,
    )
