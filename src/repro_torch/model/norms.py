"""Normalisation layers (fp32 statistics, bf16-safe).

``dual_norm`` is the LP-specific fused form: an LP pair needs both layers'
norms of the same input tensor. For RMSNorm it goes through the dual
RMSNorm kernel wrapper (``repro_torch.kernels.ops.dual_rmsnorm``), which
launches the kernel on a CUDA tensor and runs its plain version on a CPU
one — the same math as the JAX package's XLA path. The train step's
differentiable forward runs ``rmsnorm`` per path instead.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def _stats_rms(x32):
    return torch.mean(torch.square(x32), dim=-1, keepdim=True)


def rmsnorm(x, scale, *, eps: float = 1e-6, plus_one: bool = False):
    x32 = x.float()
    inv = torch.reciprocal(torch.sqrt(_stats_rms(x32) + eps))
    s = (1.0 + scale.float()) if plus_one else scale.float()
    return (x32 * inv * s).to(x.dtype)


def layernorm(x, scale, bias, *, eps: float = 1e-5):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    inv = torch.reciprocal(torch.sqrt(torch.mean(torch.square(xc), dim=-1, keepdim=True) + eps))
    return (xc * inv * scale.float() + bias.float()).to(x.dtype)


def apply_norm(x, p, cfg):
    """Dispatch on the architecture's norm kind. ``p`` is {"scale"[, "bias"]}."""
    if cfg.norm_kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
    return rmsnorm(x, p["scale"], plus_one=cfg.norm_plus_one)


def dual_norm(x, p_a, p_b, cfg, *, differentiable=False):
    """Both LP-pair norms of the same input, stacked [2, ..., D] (unpacks as
    ``ya, yb``); shares the fp32 statistics. ``differentiable`` (the train
    step's forward) runs ``rmsnorm`` once per path, in torch ops on any
    device, in place of the kernel, which has no backward."""
    if cfg.norm_kind == "rmsnorm" and differentiable:
        return torch.stack([rmsnorm(x, p["scale"], plus_one=cfg.norm_plus_one)
                            for p in (p_a, p_b)])
    if cfg.norm_kind == "rmsnorm":
        return ops.dual_rmsnorm(x, p_a["scale"], p_b["scale"],
                                plus_one=cfg.norm_plus_one)
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    xc = x32 - mu
    inv = torch.reciprocal(torch.sqrt(torch.mean(torch.square(xc), dim=-1, keepdim=True) + 1e-5))
    xn = xc * inv
    ya = xn * p_a["scale"].float() + p_a["bias"].float()
    yb = xn * p_b["scale"].float() + p_b["bias"].float()
    return torch.stack([ya, yb]).to(x.dtype)
