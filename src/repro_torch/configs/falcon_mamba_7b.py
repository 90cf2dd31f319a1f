"""Falcon-Mamba-7B — pure Mamba-1 SSM, attention-free. [arXiv:2410.05355]"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

FALCON_MAMBA_7B = register(ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,                 # attention-free, FFN-free: each layer is one mixer
    vocab_size=65024,
    block_pattern=(LayerSpec(mixer="mamba", ffn=None),),
    norm_kind="rmsnorm",
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,           # d_inner = 8192
    dt_rank=256,
    pos_embed="none",
    subquadratic=True,      # constant-size recurrent state
    notes="LP generalises to paired residual mixer blocks: "
          "y = x + M_k(LN_k x) + M_{k+1}(LN_{k+1} x) — one psum per pair.",
))
