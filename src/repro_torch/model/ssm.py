"""Mamba-1 selective SSM mixer (falcon-mamba).

Ported from the JAX package's ``model/ssm.py``. Everything carries a
leading path axis P (1 = single layer, 2 = LP pair), so single layers and
pairs share one code path; the pair's x_proj partials go through ONE
``psum_tp`` and its per-path output projections sum into the phase's one
exit reduction.

Full-sequence mode (prefill) runs the recurrence through the selective-scan
kernel wrapper ``kernels.ops.ssm_scan`` on ``[P*B, S, d_inner, N]``: the
kernel on a CUDA tensor, its plain sequential version on a CPU one (the JAX
package's prefill takes its XLA chunked scan there; sums are grouped
differently, so the two agree within a tolerance). State mode (decode)
advances the state one token at a time with plain torch ops, as the JAX
package does. The state ``h`` is computed and returned in fp32; the conv
state in the input's type.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.model.params import PD
from repro_torch.parallel.context import ParallelContext


def ssm_template(cfg, tp: int):
    D = cfg.d_model
    di = cfg.d_inner
    assert di % tp == 0
    R, N, K = cfg.dt_rank, cfg.ssm_state, cfg.ssm_conv
    return {
        "w_in": PD((D, 2 * di)),                      # [x; z]
        "conv_w": PD((K, di), init="normal", fan_in=K),
        "conv_b": PD((di,), init="zeros"),
        "w_x": PD((di, R + 2 * N)),
        "w_dt": PD((R, di)),
        "dt_bias": PD((di,), init="zeros"),
        "A_log": PD((di, N), init="zeros"),
        "D": PD((di,), init="ones"),
        "w_out": PD((di, D)),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv, shift-and-add in fp32. x: [P,B,S,C];
    w: [P,K,C]; b: [P,C]."""
    K, S = w.shape[1], x.shape[2]
    out = b[:, None, None, :].float()
    for j in range(K):
        shift = K - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :, :S, :]
        out = out + xs.float() * w[:, j][:, None, None, :].float()
    return out.to(x.dtype)


def _scan_seq(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t over axis 2. a, b: [P,B,S,C,N]."""
    h = h0
    ys = []
    for t in range(a.shape[2]):
        h = a[:, :, t] * h + b[:, :, t]
        ys.append(h)
    return torch.stack(ys, dim=2), h


def _pmm(x, w):
    """Per-path matmul, B·S folded into one bmm per path: x [P,B,S,K];
    w [P,K,E] -> [P,B,S,E]."""
    Pp, B, S, K = x.shape
    return torch.bmm(x.reshape(Pp, B * S, K), w).reshape(Pp, B, S, w.shape[-1])


def ssm_mix(p, xn, cfg, pc: ParallelContext, *, state=None):
    """xn: [P,B,S,D] per-path normalised inputs. Returns (partial [B,S,D],
    new_state) where state = (conv_state [P,B,K-1,di], h [P,B,di,N] fp32).
    When ``state`` is given, runs in stateful (decode) mode."""
    Pp, B, S, D = xn.shape
    N, K = cfg.ssm_state, cfg.ssm_conv
    w_in = p["w_in"]
    di = w_in.shape[-1] // 2

    xz = _pmm(xn, w_in.to(xn.dtype))
    xin, z = xz[..., :di], xz[..., di:]

    if state is not None:
        conv_prev, h_prev = state
        xcat = torch.cat([conv_prev.to(xin.dtype), xin], dim=2)
        new_conv = xcat[:, :, -(K - 1):, :]
        xc = _causal_conv(xcat, p["conv_w"], p["conv_b"])[:, :, -S:, :]
    else:
        xc = _causal_conv(xin, p["conv_w"], p["conv_b"])
        new_conv = (xin[:, :, -(K - 1):, :] if S >= K - 1
                    else F.pad(xin, (0, 0, K - 1 - S, 0)))
        h_prev = torch.zeros((Pp, B, di, N), dtype=torch.float32,
                             device=xn.device)
    xc = F.silu(xc.float()).to(xc.dtype)

    # x_proj: ONE stacked reduction for all paths.
    bcd = pc.psum_tp(_pmm(xc, p["w_x"].to(xc.dtype)).float())
    R = cfg.dt_rank
    dt_raw, Bt, Ct = bcd[..., :R], bcd[..., R:R + N], bcd[..., R + N:]

    dt = F.softplus(_pmm(dt_raw, p["w_dt"].float())
                    + p["dt_bias"][:, None, None, :].float())       # [P,B,S,di]
    A = -torch.exp(p["A_log"].float())                              # [P,di,N]
    a = torch.exp(dt[..., None] * A[:, None, None])                 # [P,B,S,di,N]
    b = (dt * xc.float())[..., None] * Bt[..., None, :]             # [P,B,S,di,N]

    if state is not None:
        y, hT = _scan_seq(a, b, h_prev.float())
    else:
        y2, h2 = ops.ssm_scan(a.reshape(Pp * B, S, di, N),
                              b.reshape(Pp * B, S, di, N),
                              h_prev.reshape(Pp * B, di, N))
        y, hT = y2.reshape(Pp, B, S, di, N), h2.reshape(Pp, B, di, N)

    yout = ((y * Ct[..., None, :]).sum(-1)
            + p["D"][:, None, None, :].float() * xc.float())
    yout = yout * F.silu(z.float())
    # Per-path output projections, summed over P.
    out = _pmm(yout.to(xn.dtype), p["w_out"].to(xn.dtype)).sum(0)
    return out, (new_conv, hT)
