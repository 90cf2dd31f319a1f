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
    """Allowed-mask [..., S, T] for q positions [..., S] x k positions [T]."""
    q = qpos[..., None]
    k = kpos[None, :]
    if kind == "bidir":
        return torch.ones(qpos.shape + kpos.shape, dtype=torch.bool,
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
    as the kernel takes them; masks then use position = row // g. ``q0`` is
    an int, or a [BH] tensor of per-row query offsets."""
    S, T = q.shape[1], k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsh,bth->bst", q.float(), k.float()) * scale
    rel = torch.arange(S, device=q.device) // q_group
    qpos = q0[:, None] + rel if torch.is_tensor(q0) else q0 + rel
    m = _mask(kind, qpos, k0 + torch.arange(T, device=q.device),
              window=window, chunk=chunk, prefix_len=prefix_len)
    s = torch.where(m if m.dim() == 3 else m[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bst,bth->bsh", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, t_valid):
    """q: [B, Hkv, g, hd]; k, v: [B, L, Hkv, hd]; entries with index > t_valid
    masked (an int, or a [B] tensor of per-row horizons). Returns
    [B, Hkv, g, hd]."""
    L = k.shape[1]
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bngh,btnh->bngt", q.float(), k.float()) * scale
    if torch.is_tensor(t_valid):
        t_valid = t_valid.reshape(-1, 1, 1, 1)
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


def gather_pages(pages, block_tables):
    """pages [n_pages, ps, Hkv, hd]; block_tables [B, n_pg] -> the rows'
    logical sequences [B, n_pg * ps, Hkv, hd]."""
    g = pages[block_tables.long()]                 # [B, n_pg, ps, Hkv, hd]
    return g.reshape(g.shape[0], -1, *g.shape[3:])


def decode_attention_paged_ref(q, k_pages, v_pages, block_tables, t_valid,
                               head_map=None):
    """Paged form: q [B, Hkv, g, hd]; k/v_pages [n_pages, ps, Hs, hd];
    block_tables [B, n_pg]; t_valid [B] per-row horizons; head_map: an
    optional [Hkv] int map from q's kv head h to the pool's stored head
    ``head_map[h]`` (without one, Hs == Hkv). Gathers each row's pages (and
    the mapped heads) into [B, L, Hkv, hd] and applies the ring math."""
    if head_map is not None:
        k_pages = k_pages.index_select(2, head_map.long())
        v_pages = v_pages.index_select(2, head_map.long())
    return decode_attention_ref(q, gather_pages(k_pages, block_tables),
                                gather_pages(v_pages, block_tables), t_valid)


def decode_attention_pair_paged_ref(q, k_pages, v_pages, block_tables,
                                    t_valid, head_map=None):
    """Pair form over the stacked pool [2, n_pages, ps, Hs, hd], one block
    table and one head map shared by both halves: q [2, B, Hkv, g, hd] ->
    [2, B, Hkv, g, hd]."""
    return torch.stack([decode_attention_paged_ref(
        q[i], k_pages[i], v_pages[i], block_tables, t_valid, head_map)
        for i in range(2)])


def ssm_scan_ref(a, b, h0):
    """h_t = a_t * h_{t-1} + b_t. a, b: [B, S, C, N]; h0: [B, C, N].
    Returns (h_1..S [B,S,C,N], h_S), in the type the operands promote to."""
    h = h0
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        ys.append(h)
    return torch.stack(ys, dim=1), h
