"""Mixture-of-Experts FFN (dbrx-132b, llama4-scout), single layer and LP pair.

Ported from the JAX package's ``model/moe.py``: top-k routing, a capacity
bounded cumsum dispatch into per-expert buffers, the expert products, and a
weighted combine back to the tokens. An LP pair runs its two layers' expert
sets as two dispatches whose outputs are summed, and its two aux losses are
halved (the pair still costs one phase reduction). Aux output
(load-balance loss) follows Switch/GShard: mean(frac_tokens *
frac_router_prob) * E.

Tensor parallelism is expert parallelism, as in the JAX package: every rank
routes the same replicated tokens (capacity C from the global token count),
rank r owns experts [r*E/tp, (r+1)*E/tp) and dispatches only the slots that
land there (a foreign slot goes to the trash row like a dropped one), and
the shared expert (llama4) is split column/row like an MLP. The output is
the rank's partial sum, which the phase's one ``psum_tp`` completes.

What keeps the port's answers the JAX package's, and its own bitwise
invariants (engine == ``generate``, a row alone == the row in a batch):

* top-k from a stable descending sort: on equal probabilities the lower
  expert index comes first, as ``lax.top_k`` orders them;
* the slot of each (token, choice) inside its expert's buffer is a cumsum
  over all T*k slots in token-major order, dropped slots included, and a
  slot at or past the capacity C is dropped: the same slots as JAX;
* no atomics: every kept slot owns one (expert, position) of the buffer,
  so the dispatch is a plain index write (dropped slots go to a trash row
  C, which is cut off), and the combine gathers each token's k weighted
  expert outputs and adds them j = 0..k-1 in order, from zeros, in the
  activation type, as JAX's scatter-add does;
* no host syncs: fixed shapes, clamped indices and ``where``, no boolean
  indexing and no ``nonzero``;
* dispatch and combine run ``CHUNK`` slots at a time, as JAX's do: the
  sums are the unchunked ones, and the [T*k, D] temporaries of a long
  prefill stay bounded.
"""
from __future__ import annotations

import math

import torch

from repro_torch.model.mlp import _ACTS
from repro_torch.model.params import PD, tree_map

#: Slots a dispatch or combine materialises at a time (JAX's CHUNK).
CHUNK = 16384


def moe_template(cfg, tp: int):
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe_experts
    assert E % tp == 0, (cfg.name, E, tp)
    t = {
        "router": PD((D, E), fan_in=D),
        "w_up": PD((E, D, F), split=0),
        "w_down": PD((E, F, D), split=0),
    }
    if cfg.mlp_gated:
        t["w_gate"] = PD((E, D, F), split=0)
    if cfg.moe_shared_expert:
        t["shared"] = {"w_up": PD((D, F), split=1), "w_down": PD((F, D), split=0)}
        if cfg.mlp_gated:
            t["shared"]["w_gate"] = PD((D, F), split=1)
    return t


def capacity(n_tokens: int, cfg) -> int:
    c = int(math.ceil(n_tokens * cfg.moe_top_k * cfg.moe_capacity_factor / cfg.moe_experts))
    return max(8, -(-c // 8) * 8)  # pad to a multiple of 8


def _route(router_logits, cfg):
    """Top-k routing. Returns (expert_idx [T,k], weight [T,k] fp32,
    aux_loss)."""
    probs = torch.softmax(router_logits.float(), dim=-1)   # [T,E]
    # Stable: equal probabilities keep ascending expert order (lax.top_k's).
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.moe_top_k
    w, idx = w[:, :k], idx[:, :k]
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # Switch-style load-balance aux loss.
    E = cfg.moe_experts
    hot = (idx[:, :1] == torch.arange(E, device=idx.device)).float()  # primary
    aux = (hot.mean(0) * probs.mean(0)).sum() * E
    return idx, w, aux


def slot_positions(idx, cfg):
    """(slot_expert [T*k], pos_in_expert [T*k], keep [T*k]) of the routing
    ``idx`` [T,k]: each slot's position inside its expert's buffer, counted
    over all slots in token-major order (dropped ones included), and whether
    it falls below the capacity C = ``capacity(T, cfg)``."""
    E = cfg.moe_experts
    slot_expert = idx.reshape(-1)
    onehot = (slot_expert[:, None] == torch.arange(E, device=idx.device)).long()
    before = torch.cumsum(onehot, dim=0) - onehot              # [T*k,E]
    pos = before.gather(1, slot_expert[:, None])[:, 0]
    return slot_expert, pos, pos < capacity(idx.shape[0], cfg)


def moe_forward(p, xn, cfg, pc, *, pair: bool):
    """xn: [B,S,D] or [2,B,S,D]. Returns (partial_out [B,S,D], aux_loss);
    the caller runs phase_out. The aux loss, which every rank computes
    alike from the router, leaves the phase without a sum: under autograd
    its gradient is split over the ranks (``split_grad_tp``), as the
    router's other gradients (through the rank's experts) are."""
    if pair:
        out_a, aux_a = _moe_single(tree_map(lambda v: v[0], p), xn[0], cfg, pc)
        out_b, aux_b = _moe_single(tree_map(lambda v: v[1], p), xn[1], cfg, pc)
        out, aux = out_a + out_b, 0.5 * (aux_a + aux_b)
    else:
        out, aux = _moe_single(p, xn, cfg, pc)
    return out, pc.split_grad_tp(aux)


def _moe_single(p, xn, cfg, pc):
    B, S, D = xn.shape
    T = B * S
    E, k = cfg.moe_experts, cfg.moe_top_k
    e_local = E // pc.tp_size
    C = capacity(T, cfg)
    x = xn.reshape(T, D)

    idx, w, aux = _route(x @ p["router"].to(x.dtype), cfg)      # [T,k]
    slot_expert, pos, keep = slot_positions(idx, cfg)
    slot_token = torch.arange(T, device=x.device).repeat_interleave(k)
    # This rank owns experts [lo, lo + e_local); dropped and foreign slots
    # write to the trash row C (cut off below).
    local_e = slot_expert - pc.tp_index() * e_local
    keep = keep & (local_e >= 0) & (local_e < e_local)
    le = torch.where(keep, local_e, 0)
    pe = torch.where(keep, pos, C)

    n_slots = T * k
    buf = torch.zeros((e_local, C + 1, D), dtype=x.dtype, device=x.device)
    for a in range(0, n_slots, CHUNK):
        b = min(a + CHUNK, n_slots)
        kp = keep[a:b, None]
        buf[le[a:b], pe[a:b]] = torch.where(kp, x[slot_token[a:b]], 0)
    buf = buf[:, :C]

    act = _ACTS[cfg.mlp_act]
    up = torch.bmm(buf, p["w_up"].to(buf.dtype))
    if cfg.mlp_gated:
        gate = torch.bmm(buf, p["w_gate"].to(buf.dtype))
        h = act(gate.float()).to(up.dtype) * up
    else:
        h = act(up.float()).to(up.dtype)
    eout = torch.bmm(h, p["w_down"].to(h.dtype))                 # [E/tp,C,D]

    # Combine: each token's k slots are consecutive and CHUNK % k == 0, so
    # a chunk of slots is a run of whole tokens; their weighted outputs are
    # added choice by choice, from zeros, in x's type.
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device)
    pe0 = torch.where(keep, pos, 0)
    ws = w.reshape(-1).to(x.dtype)
    for a in range(0, n_slots, CHUNK):
        b = min(a + CHUNK, n_slots)
        g = eout[le[a:b], pe0[a:b]]                              # [b-a,D]
        c = torch.where(keep[a:b, None], g * ws[a:b, None], 0).reshape(-1, k, D)
        o = out[a // k:b // k]
        for j in range(k):
            o = o + c[:, j]
        out[a // k:b // k] = o

    if cfg.moe_shared_expert:
        sp = p["shared"]
        sup = x @ sp["w_up"].to(x.dtype)
        if cfg.mlp_gated:
            sg = x @ sp["w_gate"].to(x.dtype)
            sh = act(sg.float()).to(sup.dtype) * sup
        else:
            sh = act(sup.float()).to(sup.dtype)
        out = out + sh @ sp["w_down"].to(sh.dtype)   # the rank's partial

    return out.reshape(B, S, D), aux
