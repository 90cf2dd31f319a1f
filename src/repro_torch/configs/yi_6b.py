"""Yi-6B — llama-arch dense decoder with GQA. [arXiv:2403.04652; hf]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

YI_6B = register(ArchConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=True,
    mlp_act="silu",
    norm_kind="rmsnorm",
    notes="Llama-style GQA; RoPE theta 5M for 4k context.",
))
