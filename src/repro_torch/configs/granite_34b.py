"""Granite-34B-Code — GPTBigCode-style: MQA (kv=1), non-gated GeLU MLP,
LayerNorm, learned absolute positions. [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

GRANITE_34B = register(ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    pos_embed="learned",
    max_position=8192,
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp"),),
    mlp_gated=False,
    mlp_act="gelu",
    norm_kind="layernorm",
    attn_bias=True,
    mlp_bias=True,
    notes="Deepest assigned arch (88L) — the scan-based stack keeps HLO size "
          "flat in depth. MQA kv=1 is replicated across TP for train/prefill "
          "and sequence-sharded for decode.",
))
