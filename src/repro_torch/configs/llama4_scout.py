"""Llama-4-Scout-17B-16E backbone — MoE (16 experts, top-1, shared expert),
iRoPE attention: 3 chunked-attention layers per 1 global NoPE layer.
[hf:meta-llama/Llama-4-Scout-17B-16E]

40 heads do not divide the 16-way TP axis; padded to 48 (DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

LLAMA4_SCOUT = register(ArchConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,              # per-expert width
    vocab_size=202048,
    rope_theta=500_000.0,
    chunk=8192,
    block_pattern=(
        LayerSpec(mixer="attn_chunked", ffn="moe"),
        LayerSpec(mixer="attn_chunked", ffn="moe"),
        LayerSpec(mixer="attn_chunked", ffn="moe"),
        LayerSpec(mixer="attn_global", ffn="moe"),
    ),
    mlp_gated=True,
    mlp_act="silu",
    norm_kind="rmsnorm",
    moe_experts=16,
    moe_top_k=1,
    moe_shared_expert=True,
    subquadratic=True,      # 3/4 of layers use chunk-8192 attention
    notes="Chunked attention keeps 500k-decode KV per chip bounded; the 12 "
          "global NoPE layers shard their KV along sequence over the model axis.",
))
