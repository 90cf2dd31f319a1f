"""Whisper-medium backbone — encoder-decoder transformer; the conv audio
frontend is a STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356]

24 encoder layers (bidirectional attention) + 24 decoder layers (causal
self-attention + cross-attention). LayerNorm, GeLU, non-gated MLP, learned
positions — faithful to the original.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

WHISPER_MEDIUM = register(ArchConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,          # decoder depth
    enc_layers=24,        # encoder depth
    enc_seq=1500,         # 30 s of audio at 50 Hz after the conv stub
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    pos_embed="learned",
    max_position=32768 + 8,  # decode_32k exercises a 32k decoder context
    block_pattern=(LayerSpec(mixer="attn", ffn="mlp", cross_attn=True),),
    mlp_gated=False,
    mlp_act="gelu",
    norm_kind="layernorm",
    attn_bias=True,
    mlp_bias=True,
    notes="Conv frontend stubbed: encoder consumes (B, 1500, d_model) frame "
          "embeddings. Decoder-side LP pairs both self- and cross-attention "
          "sub-blocks of consecutive layers.",
))
