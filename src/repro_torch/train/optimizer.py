"""AdamW + LR schedules (WSD per MiniCPM, cosine, linear, constant).

The JAX package's functions on the port's tensors: decoupled weight decay
per Loshchilov & Hutter, in JAX's order of operations — the decay is added
to the Adam direction before the learning rate scales both
(``p - lr * (m̂ / (√v̂ + eps) + wd·mask·p)``), where ``torch.optim.AdamW``
multiplies the weights by (1 - lr·wd) in a separate step and so rounds
differently. The paper's fine-tuning recipe (Table 2) is AdamW with a
linear decay from 1e-4.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: str = "wsd"  # wsd | cosine | linear | const
    warmup_steps: int = 100
    total_steps: int = 1000
    decay_frac: float = 0.1  # WSD: final fraction of steps spent decaying
    min_lr_frac: float = 0.0


def schedule_lr(opt: OptConfig, step) -> torch.Tensor:
    """LR at ``step`` (0-based) as a 0-dim fp32 tensor on the CPU, computed
    in fp32 in the JAX package's order."""
    s = torch.tensor(float(step), dtype=torch.float32)
    # (s+1)/warmup so step 0 trains at lr/warmup, not 0; warmup=0 disables.
    warm = torch.clamp_max((s + 1.0) / max(opt.warmup_steps, 1), 1.0)
    total = float(opt.total_steps)
    lo = opt.min_lr_frac
    if opt.schedule == "const":
        frac = torch.tensor(1.0, dtype=torch.float32)
    elif opt.schedule == "linear":
        frac = torch.clamp_min(1.0 - s / total, lo)
    elif opt.schedule == "cosine":
        prog = torch.clamp(s / total, 0.0, 1.0)
        frac = lo + (1 - lo) * 0.5 * (1 + torch.cos(math.pi * prog))
    elif opt.schedule == "wsd":
        # Warmup -> Stable -> Decay (MiniCPM): stable at lr, then linear
        # decay over the last decay_frac of training.
        decay_start = total * (1.0 - opt.decay_frac)
        prog = torch.clamp((s - decay_start) / max(total - decay_start, 1.0),
                           0.0, 1.0)
        frac = 1.0 - (1.0 - lo) * prog
    else:
        raise ValueError(opt.schedule)
    return opt.lr * warm * frac


def adamw_update(g, m, v, p, step, opt: OptConfig, *, lr, wd_mask=1.0):
    """One AdamW step on fp32 tensors (``step`` 0-based; ``lr`` a number or
    ``schedule_lr``'s 0-dim tensor, which a CUDA kernel takes as a scalar).
    Returns (new_p, new_m, new_v); the inputs are not modified."""
    g = g.float()
    m = opt.beta1 * m + (1 - opt.beta1) * g
    v = opt.beta2 * v + (1 - opt.beta2) * torch.square(g)
    t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
    mhat = m / (1 - opt.beta1 ** t)
    vhat = v / (1 - opt.beta2 ** t)
    upd = mhat / (torch.sqrt(vhat) + opt.eps) + opt.weight_decay * wd_mask * p
    return p - lr * upd, m, v


def clip_by_global_norm_(grads, max_norm: float, sq_sum) -> torch.Tensor:
    """Scale the fp32 grads IN PLACE by min(1, max_norm / global L2 norm),
    where ``sq_sum`` is their sum of squares, already reduced over every
    rank that holds a part. Returns the norm."""
    norm = torch.sqrt(sq_sum)
    scale = torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)
    for g in grads:
        g.mul_(scale)
    return norm
