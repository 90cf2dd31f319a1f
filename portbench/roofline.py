"""The yardstick of the per-layer metrics: the card's published peaks, the
model's operations per token, and the operations and bytes each kernel's
work needs, counted from the requests' true shapes (never from a launch's
padded shape), so whatever later implements a kernel is held to the same
work.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3. The model count is the port's
``analysis/roofline.py`` convention: 2 N operations a token, N the
parameters without the embedding lookup (the LM head counts).
"""
from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
BF16 = 2
FP32 = 4


def layer_params(cfg: dict) -> int:
    D = cfg["hidden_size"]
    if cfg["family"] == "dense":
        hd, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
        return 2 * D * hq * hd + 2 * D * hkv * hd + 3 * D * cfg["intermediate_size"]
    di, N, K, R = (cfg["intermediate_size"], cfg["state_size"], cfg["conv_kernel"],
                   cfg["time_step_rank"])
    return D * 2 * di + K * di + di * (R + 2 * N) + R * di + di + di * N + di + di * D


def matmul_params(cfg: dict) -> int:
    """N: every layer and the LM head; the embedding lookup is not a
    product."""
    return cfg["num_hidden_layers"] * layer_params(cfg) + cfg["hidden_size"] * cfg["vocab_size"]


def model_flops(cfg: dict, tokens: int) -> float:
    return 2.0 * matmul_params(cfg) * tokens


def attn_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] if cfg["family"] == "dense" else 0


def paged_decode_bytes(cfg: dict, ctx: list) -> float:
    """Bytes one decode of each row needs, over every attention layer: its
    q and out once, and the k and v of its true context (``ctx`` kv
    positions a row, the new one included) once. bf16."""
    hd, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    per_row = 2 * hq * hd * BF16
    per_pos = 2 * hkv * hd * BF16
    return attn_layers(cfg) * (len(ctx) * per_row + sum(ctx) * per_pos)


def flash_prefill(cfg: dict, lens: list) -> tuple:
    """(operations, bytes) of causal prefill attention over prompts of
    true lengths ``lens``, every attention layer: QK^T and PV over the
    L(L+1)/2 causal pairs, and q, k, v and out once, bf16."""
    hd, hq, hkv = cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ops = sum(4.0 * hq * hd * L * (L + 1) / 2 for L in lens)
    byts = sum((2 * hq * hd + 2 * hkv * hd) * L * BF16 for L in lens)
    return attn_layers(cfg) * ops, attn_layers(cfg) * byts


def ssm_scan_bytes(cfg: dict, lens: list) -> float:
    """Bytes of the selective scan's interface at true lengths, every Mamba
    layer: a, b and y ([L, d_inner, N], fp32) and the states h0, hT once."""
    if cfg["family"] != "mamba":
        return 0
    di, N = cfg["intermediate_size"], cfg["state_size"]
    return cfg["num_hidden_layers"] * sum((3 * L + 2) * di * N * FP32 for L in lens)


def bound_s(ops: float, byts: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory term."""
    return max(ops / BF16_FLOPS, byts / HBM_BYTES_S)


def mfu(cfg: dict, steps) -> float:
    """Percent of the bf16 peak: 2 N operations for each token through
    the model (prompt tokens prefilled, tokens decoded) over the window."""
    tokens = sum(s.prompt_tokens + s.decode_tokens for s in steps)
    secs = steps[-1].t1 - steps[0].t0
    return 100.0 * model_flops(cfg, tokens) / secs / BF16_FLOPS
