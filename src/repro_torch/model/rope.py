"""Rotary position embeddings (fp32 rotation, llama rotate-half convention)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)  # (head_dim/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    x1, x2 = x32[..., : hd // 2], x32[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
