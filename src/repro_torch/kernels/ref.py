"""Plain PyTorch versions of the kernels (the allclose targets).

Ported as written from the JAX package's ``kernels/ref.py``. They run on
any device: the kernel wrappers (``repro_torch.kernels.ops``) take them for
CPU tensors, and ``chip_smoke.py`` holds each kernel against them on the
card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def dual_rmsnorm_ref(x, sa, sb, *, eps=1e-6, plus_one=False):
    """x: [M, D]; sa, sb: [D] -> (ya, yb) both [M, D]."""
    x32 = x.float()
    inv = torch.reciprocal(torch.sqrt(torch.mean(torch.square(x32), -1, keepdim=True) + eps))
    xn = x32 * inv
    a = (1.0 + sa.float()) if plus_one else sa.float()
    b = (1.0 + sb.float()) if plus_one else sb.float()
    return (xn * a).to(x.dtype), (xn * b).to(x.dtype)


def _mask(kind, qpos, kpos, *, window=0, chunk=0, prefix_len=0):
    q = qpos[:, None]
    k = kpos[None, :]
    if kind == "bidir":
        return torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                          device=qpos.device)
    m = k <= q
    if kind == "causal":
        if prefix_len:
            m = m | (k < prefix_len)
        return m
    if kind == "window":
        return m & (q - k < window)
    if kind == "chunk":
        return m & (q // chunk == k // chunk)
    raise ValueError(kind)


def flash_attention_ref(q, k, v, *, kind="causal", window=0, chunk=0,
                        prefix_len=0, q0=0, k0=0, q_group=1):
    """q: [BH, S, hd]; k, v: [BH, T, hd] -> [BH, S, hd] (fp32 math).

    ``q_group`` > 1 means q rows are GQA-folded (row = position*g + head),
    as the kernel takes them; masks then use position = row // g."""
    S, T = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsh,bth->bst", q.float(), k.float()) * scale
    qpos = q0 + torch.arange(S, device=q.device) // q_group
    m = _mask(kind, qpos, k0 + torch.arange(T, device=q.device),
              window=window, chunk=chunk, prefix_len=prefix_len)
    s = torch.where(m[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,bth->bsh", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, t_valid):
    """q: [B, Hkv, g, hd]; k, v: [B, L, Hkv, hd]; entries with index > t_valid
    masked. Returns [B, Hkv, g, hd]."""
    L = k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bngh,btnh->bngt", q.float(), k.float()) * scale
    valid = torch.arange(L, device=q.device)[None, None, None, :] <= t_valid
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bngt,btnh->bngh", p, v.float()).to(q.dtype)


def decode_attention_pair_ref(q, k, v, t_valid):
    """Pair form: q [2, B, Hkv, g, hd]; k, v [2, B, L, Hkv, hd] (the stacked
    pair cache) -> [2, B, Hkv, g, hd]. Both halves share ``t_valid``."""
    P2, B = q.shape[0], q.shape[1]
    o = decode_attention_ref(q.reshape(P2 * B, *q.shape[2:]),
                             k.reshape(P2 * B, *k.shape[2:]),
                             v.reshape(P2 * B, *v.shape[2:]), t_valid)
    return o.reshape(q.shape)
