"""MLP (gated SwiGLU/GeGLU or plain 2-matrix), single layer and LP pair.

Tensor parallel as Megatron: the up (and gate) projections split their
d_ff columns over the ranks, the down projection its rows, so each rank
returns a partial sum (its share of the replicated ``b_down`` added as
``b_down / tp``) that the caller's phase_out adds up.

LP pairs: both layers' up projections run as one batched matmul over a
leading pair axis; the down projection is two per-path gemms and one
explicit add, as in the JAX package (mlp.py), which pins the reduction
grouping so it does not depend on the sequence length.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.model.attention import pair_matmul
from repro_torch.model.params import PD

_ACTS = {"silu": F.silu,
         "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
         "relu": F.relu}


def mlp_template(cfg, tp: int):
    D, Fd = cfg.d_model, cfg.d_ff
    assert Fd % tp == 0, (cfg.name, Fd, tp)
    t = {"w_up": PD((D, Fd), split=1), "w_down": PD((Fd, D), split=0)}
    if cfg.mlp_gated:
        t["w_gate"] = PD((D, Fd), split=1)
    if getattr(cfg, "mlp_bias", False):
        t["b_up"] = PD((Fd,), init="zeros", split=0)
        t["b_down"] = PD((D,), init="zeros")
    return t


def mlp_forward(p, xn, cfg, tp: int, *, pair: bool):
    """xn: [B,S,D] or [2,B,S,D] (pair, per-path normalised inputs).
    Returns the PARTIAL output [B,S,D]; the caller runs phase_out."""
    act = _ACTS[cfg.mlp_act]
    if pair:
        up = pair_matmul(xn, p["w_up"].to(xn.dtype))
        if p.get("b_up") is not None:
            up = up + p["b_up"][:, None, None, :].to(up.dtype)
        if cfg.mlp_gated:
            gate = pair_matmul(xn, p["w_gate"].to(xn.dtype))
            h = act(gate.float()).to(up.dtype) * up
        else:
            h = act(up.float()).to(up.dtype)
        # Per-path down projections + one explicit add (see module doc).
        wd = p["w_down"].to(h.dtype)
        y = h[0] @ wd[0] + h[1] @ wd[1]
    else:
        up = xn @ p["w_up"].to(xn.dtype)
        if p.get("b_up") is not None:
            up = up + p["b_up"].to(up.dtype)
        if cfg.mlp_gated:
            gate = xn @ p["w_gate"].to(xn.dtype)
            h = act(gate.float()).to(up.dtype) * up
        else:
            h = act(up.float()).to(up.dtype)
        y = h @ p["w_down"].to(h.dtype)
    if p.get("b_down") is not None:
        bd = p["b_down"].float()
        if pair:
            bd = bd.sum(dim=0)  # both paths' biases enter the one reduction
        y = y + (bd / tp).to(y.dtype)
    return y
