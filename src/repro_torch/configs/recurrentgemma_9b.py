"""RecurrentGemma-9B — Griffin hybrid: RG-LRU recurrent blocks + local
attention at a 2:1 ratio (pattern rec, rec, attn_local). [arXiv:2402.19427]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

RECURRENTGEMMA_9B = register(ArchConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,  # 12 full (rec,rec,attn) periods + trailing (rec, rec)
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    window=2048,
    rope_theta=10_000.0,
    block_pattern=(
        LayerSpec(mixer="rec", ffn="mlp"),
        LayerSpec(mixer="rec", ffn="mlp"),
        LayerSpec(mixer="attn_local", ffn="mlp"),
    ),
    mlp_gated=True,
    mlp_act="gelu",          # GeGLU
    norm_kind="rmsnorm",
    norm_plus_one=True,      # gemma-style (1 + scale)
    lru_width=4096,
    rec_conv=4,
    subquadratic=True,       # window-2048 attention + constant-state RG-LRU
    notes="LP pairs the two consecutive RG-LRU layers of each period; the "
          "lone local-attention layer stays sequential.",
))
