"""PaliGemma-3B backbone — Gemma-2B decoder + SigLIP vision frontend STUB
(input_specs provides 256 precomputed patch embeddings as a full-attention
prefix). [arXiv:2407.07726; hf]

8 heads do not divide the 16-way TP axis; padded to 16 (DESIGN.md).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

PALIGEMMA_3B = register(ArchConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    rope_theta=10_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=True,
    mlp_act="gelu",          # GeGLU
    norm_kind="rmsnorm",
    norm_plus_one=True,
    tie_embeddings=True,
    prefix_len=256,          # SigLIP patch tokens (prefix-LM attention)
    notes="Prefix tokens attend bidirectionally (prefix-LM mask); text suffix "
          "is causal. The SigLIP tower is outside the assignment scope (stub).",
))
