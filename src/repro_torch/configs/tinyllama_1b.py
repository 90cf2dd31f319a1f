"""TinyLlama-1.1B — llama2-arch small. [arXiv:2401.02385; hf]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

TINYLLAMA_1B = register(ArchConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=True,
    mlp_act="silu",
    norm_kind="rmsnorm",
))
