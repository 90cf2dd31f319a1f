"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Ported from the JAX package's ``model/rglru.py``. Structure: a gate branch
(linear -> tanh-approximate GeLU) times a recurrent branch (linear ->
causal conv -> RG-LRU), then the output projection. The input and
recurrence gates are per-channel (diagonal) weights, as in the JAX
package. Everything carries a leading path axis P (1 = single layer, 2 =
LP pair); the pair's per-path output projections sum into the phase's one
exit reduction.

The recurrence h_t = a_t * h_{t-1} + b_t is per channel: the N = 1 case of
the selective scan. Full-sequence mode (prefill) runs it through the scan
kernel wrapper ``kernels.ops.ssm_scan`` on ``[P*B, S, W, 1]`` fp32, as the
JAX package's ``impl="pallas"`` branch does: the kernel on a CUDA tensor,
its plain sequential version on a CPU one. State mode (decode), and the
train step's differentiable forward, advance the state one token at a time
with plain torch ops. The state ``h`` is computed and returned in fp32;
the conv state in the input's type. The causal conv
is the Mamba mixer's (``model/ssm.py``).

Tensor parallelism: rank r runs lru_width/tp channels (its columns of the
gate and recurrent projections, its slice of the conv and the per-channel
gates, its rows of ``w_out``). The recurrence is per channel, so the mixer
makes no collective; its output is a partial sum that the phase's exit
completes, and its state is the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.model.params import PD
from repro_torch.model.ssm import _causal_conv, _pmm, _scan_seq

_C_RGLRU = 8.0


def rglru_template(cfg, tp: int):
    D, W, K = cfg.d_model, cfg.lru_width, cfg.rec_conv
    assert W % tp == 0
    return {
        "w_gate": PD((D, W), split=1),
        "w_rec": PD((D, W), split=1),
        "conv_w": PD((K, W), fan_in=K, split=1),
        "conv_b": PD((W,), init="zeros", split=0),
        "lam": PD((W,), init="ones", split=0),    # softplus(lam) ~ decay rate
        "wa": PD((W,), init="zeros", split=0),
        "ba": PD((W,), init="zeros", split=0),
        "wx": PD((W,), init="zeros", split=0),
        "bx": PD((W,), init="zeros", split=0),
        "w_out": PD((W, D), split=0),
    }


def rglru_mix(p, xn, cfg, pc, *, state=None, differentiable=False):
    """xn: [P,B,S,D] per-path normalised inputs. Returns (partial [B,S,D],
    new_state) where state = (conv_state [P,B,K-1,W], h [P,B,W,1] fp32).
    When ``state`` is given, runs in stateful (decode) mode. The block is
    rank-local (no reduction inside), so ``pc`` is unused, as in the JAX
    package. ``differentiable`` (the train step's forward) runs the
    full-sequence recurrence by ``_scan_seq`` on any device, in place of
    the scan kernel, which has no backward."""
    Pp, B, S, D = xn.shape
    K = cfg.rec_conv

    gate = F.gelu(_pmm(xn, p["w_gate"].to(xn.dtype)).float(), approximate="tanh")
    xr = _pmm(xn, p["w_rec"].to(xn.dtype))
    W = xr.shape[-1]

    if state is not None:
        conv_prev, h_prev = state
        xcat = torch.cat([conv_prev.to(xr.dtype), xr], dim=2)
        new_conv = xcat[:, :, -(K - 1):, :]
        xc = _causal_conv(xcat, p["conv_w"], p["conv_b"])[:, :, -S:, :]
    else:
        xc = _causal_conv(xr, p["conv_w"], p["conv_b"])
        new_conv = (xr[:, :, -(K - 1):, :] if S >= K - 1
                    else F.pad(xr, (0, 0, K - 1 - S, 0)))
        h_prev = torch.zeros((Pp, B, W, 1), dtype=torch.float32,
                             device=xn.device)

    x32 = xc.float()

    def lane(name):   # a per-channel weight [P, W] against [P, B, S, W]
        return p[name].float()[:, None, None, :]

    r = torch.sigmoid(x32 * lane("wa") + lane("ba"))
    i = torch.sigmoid(x32 * lane("wx") + lane("bx"))
    log_a = -_C_RGLRU * F.softplus(p["lam"].float())[:, None, None, :] * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (i * x32)

    if state is not None or differentiable:
        y, hT = _scan_seq(a[..., None], b[..., None], h_prev.float())
    else:
        y2, h2 = ops.ssm_scan(a.reshape(Pp * B, S, W, 1),
                              b.reshape(Pp * B, S, W, 1),
                              h_prev.reshape(Pp * B, W, 1))
        y, hT = y2.reshape(Pp, B, S, W, 1), h2.reshape(Pp, B, W, 1)
    y = y[..., 0] * gate

    # Per-path output projections, summed over P.
    out = _pmm(y.to(xn.dtype), p["w_out"].to(xn.dtype)).sum(0)
    return out, (new_conv, hT)
