"""DBRX-132B — fine-grained MoE: 16 experts, top-4. [hf:databricks/dbrx-base]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

DBRX_132B = register(ArchConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab_size=100352,
    rope_theta=500_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="moe"),),
    mlp_gated=True,
    mlp_act="silu",
    norm_kind="layernorm",
    moe_experts=16,
    moe_top_k=4,
    notes="Largest assigned arch (132B total / ~36B active). ZeRO-1 over the "
          "data axis is mandatory for the optimizer state to fit 16 GB chips.",
))
