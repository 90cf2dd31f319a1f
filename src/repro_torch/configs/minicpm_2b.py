"""MiniCPM-2B — llama-like dense MHA, trained with WSD schedule.
[arXiv:2404.06395; hf]

36 heads do not divide a 16-way TP axis; the JAX package pads to 48 heads
with zero-initialised heads there. The port runs tp = 1: no padding. The
``notes`` string is the JAX package's own, kept identical (the config
copies are held equal field by field).
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

MINICPM_2B = register(ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    rope_theta=10_000.0,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=True,
    mlp_act="silu",
    norm_kind="rmsnorm",
    notes="MHA (kv=36). The paper's WSD LR schedule is implemented in "
          "repro.train.optimizer and enabled by this arch's train recipe.",
))
