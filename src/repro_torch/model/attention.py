"""Multi-head attention mixers: projections, cores and ring-cache decode.

The JAX package's conventions carry over unchanged: q heads in the grouped
layout [B,S,Hk,g,hd] (g query heads per kv head), LP pairs as a leading pair
axis on the weights with the pair folded pair-major into the head axis, and
the pair's output projection as per-path gemms plus one add.

Kernels: on a CUDA tensor ``attention_core`` runs the flash kernel for every
impl (a pinned ``"chunked:<kb>"`` becomes its fixed kv tile width),
``decode_attn_standard`` runs the ring decode kernel and
``decode_attn_paged`` the paged one, each one launch for both halves of a
pair. On a CPU tensor the impls are the plain cores below and decode runs
the kernel's plain version. Decode updates the cache in place: the new
token's k/v are index-assigned into the stored ring cache or page pool.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.model.params import PD
from repro_torch.model.rope import apply_rope

NEG_INF = -1e30

#: kv tile width of the flash kernel for impls that do not pin one.
FLASH_BLOCK_N = 64


# ---------------------------------------------------------------------------
# Static dimension bookkeeping
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnDims:
    hq: int             # q heads
    hkv: int            # kv heads
    group: int          # q heads per kv head (GQA group)
    hd: int


def attn_dims(cfg, tp: int) -> AttnDims:
    """Head counts at world size 1 (tensor parallelism is not ported)."""
    if tp != 1:
        raise NotImplementedError(f"tp={tp}: tensor parallelism is not ported")
    if cfg.n_heads == 0:  # attention-free arch (falcon-mamba)
        return AttnDims(0, 0, 1, cfg.head_dim or 1)
    assert cfg.n_heads % cfg.n_kv_heads == 0, (cfg.n_heads, cfg.n_kv_heads)
    return AttnDims(cfg.n_heads, cfg.n_kv_heads,
                    cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)


def attn_template(cfg, tp: int):
    d = attn_dims(cfg, tp)
    D = cfg.d_model
    t = {
        "wq": PD((D, d.hq * d.hd)),
        "wk": PD((D, d.hkv * d.hd)),
        "wv": PD((D, d.hkv * d.hd)),
        "wo": PD((d.hq * d.hd, D)),
    }
    if getattr(cfg, "attn_bias", False):
        t["bq"] = PD((d.hq * d.hd,), init="zeros")
        t["bk"] = PD((d.hkv * d.hd,), init="zeros")
        t["bv"] = PD((d.hkv * d.hd,), init="zeros")
        t["bo"] = PD((D,), init="zeros")
    return t


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

def tile_mask(kind: str, qpos, kpos, *, window=0, chunk=0, prefix_len=0):
    """Boolean allowed-mask [qb, kb] for absolute q positions x k positions."""
    q = qpos[..., None]
    k = kpos[None, :]
    if kind == "attn_bidir":
        return torch.ones(qpos.shape + kpos.shape, dtype=torch.bool,
                          device=qpos.device)
    causal = k <= q
    if kind in ("attn", "attn_global"):
        if prefix_len:
            return causal | (k < prefix_len)
        return causal
    if kind == "attn_local":
        return causal & (q - k < window)
    if kind == "attn_chunked":
        return causal & (q // chunk == k // chunk)
    raise ValueError(kind)


def _uses_rope(cfg, kind: str) -> bool:
    return cfg.pos_embed == "rope" and kind not in ("attn_global", "attn_bidir")


# ---------------------------------------------------------------------------
# Attention cores (grouped layout: q [B,S,Hk,g,hd], kv [B,T,Hk,hd])
# ---------------------------------------------------------------------------

def _dense_core(q, k, v, mask):
    """Materialised-scores reference core (small S*T only)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bsngh,btnh->bngst", q.float(), k.float())
    bias = torch.where(mask, 0.0, NEG_INF)[:, None, None, :, :]
    s = s * scale + bias
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bngst,btnh->bsngh", p, v.float())
    return o.to(q.dtype)


def _chunked_core(q, k, v, *, kind, window, chunk, prefix_len, q0, k0,
                  qb: int, kb: int, fixed_kb: bool = False):
    """Online-softmax (flash-style) core over q and kv tiles. ``q0``/``k0``
    are the absolute offsets of q and k position 0. Ragged S/T are padded to
    tile multiples; padded kv columns are masked via ``k_limit``.

    ``fixed_kb`` pins the kv tile width at ``kb`` even when T < kb (pad up
    instead of clamping down). A fully masked tile is then an exact no-op
    (corr = exp(m - m) = 1, p = 0) and a partly masked tile reduces over
    the same kb lanes whatever the padded length, so right-padding the key
    axis is bit-transparent for the rows below the true length.

    ``q0`` may be a [B] tensor of PER-ROW offsets (bucketed radix-suffix
    prefill: row i's queries start at its own context length); the mask
    then resolves per row while the tile schedule stays row-independent."""
    B, S0, Hk, g, hd = q.shape
    T0 = k.shape[1]
    qb = min(qb, S0)
    if not fixed_kb:
        kb = min(kb, T0)
    pad_q = (-S0) % qb
    pad_k = (-T0) % kb
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    S, T = S0 + pad_q, T0 + pad_k
    k_limit = k0 + T0
    scale = hd ** -0.5
    nq, nk = S // qb, T // kb
    dev = q.device

    qt = q.reshape(B, nq, qb, Hk, g, hd).permute(1, 0, 3, 4, 2, 5)  # [nq,B,Hk,g,qb,hd]
    kt = k.reshape(B, nk, kb, Hk, hd).permute(1, 0, 3, 2, 4)        # [nk,B,Hk,kb,hd]
    vt = v.reshape(B, nk, kb, Hk, hd).permute(1, 0, 3, 2, 4)

    per_row = torch.is_tensor(q0)
    base = q0[:, None] if per_row else q0
    tiles = []
    for qi in range(nq):
        qpos = base + qi * qb + torch.arange(qb, device=dev)   # [qb] or [B,qb]
        m = torch.full((B, Hk, g, qb), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hk, g, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, g, qb, hd), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kpos = k0 + ki * kb + torch.arange(kb, device=dev)
            msk = tile_mask(kind, qpos, kpos, window=window, chunk=chunk,
                            prefix_len=prefix_len)  # [qb,kb] or [B,qb,kb]
            msk = msk & (kpos < k_limit)[None, :]   # kv padding columns
            s = torch.einsum("bngqh,bnkh->bngqk", qt[qi].float(),
                             kt[ki].float()) * scale
            bias = torch.where(msk, 0.0, NEG_INF)
            s = s + (bias[:, None, None] if per_row else bias)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bngqk,bnkh->bngqh", p, vt[ki].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        tiles.append(out.to(q.dtype))
    out = torch.stack(tiles).permute(1, 0, 4, 2, 3, 5).reshape(B, S, Hk, g, hd)
    return out[:, :S0] if pad_q else out


_KERNEL_KIND = {"attn": "causal", "attn_global": "causal",
                "attn_local": "window", "attn_chunked": "chunk",
                "attn_bidir": "bidir"}


def attention_core(q, k, v, *, kind, window=0, chunk=0, prefix_len=0,
                   q0=0, k0=0, impl="auto", qb=512, kb=1024):
    """Grouped attention: q [B,S,Hk,g,hd]; k, v [B,T,Hk,hd] -> q's shape.

    impl: "auto" | "dense" | "chunked" | "chunked:<kb>" (pinned kv tile
    width) | "flash". On a CUDA tensor every impl launches the flash kernel,
    with the pinned width of "chunked:<kb>" as its kv tile. On a CPU tensor
    "flash" runs the kernel wrapper's plain version (the kernel's layout
    and fold, for tests) and the others run the plain cores.

    ``q0`` may be an int32 [B] tensor of per-row offsets; then the impl
    must pin its tile ("chunked:<kb>") or be the flash kernel."""
    B, S, Hk, g, hd = q.shape
    T = k.shape[1]
    pinned = impl.startswith("chunked:")
    kernel = q.device.type != "cpu" or impl == "flash"
    if torch.is_tensor(q0) and not (pinned or kernel):
        # The dense and unpinned chunked cores would build one shared mask.
        raise NotImplementedError(
            f"per-row q0 requires a pinned chunked impl ('chunked:<kb>') or "
            f"the flash kernel, got impl={impl!r}")
    if kernel:
        block_n = int(impl.split(":", 1)[1]) if pinned else FLASH_BLOCK_N
        return ops.flash_attention(q, k, v, kind=_KERNEL_KIND[kind],
                                   window=window, chunk=chunk,
                                   prefix_len=prefix_len, q0=q0, k0=k0,
                                   block_n=block_n)
    if pinned:
        kb = int(impl.split(":", 1)[1])
        return _chunked_core(q, k, v, kind=kind, window=window, chunk=chunk,
                             prefix_len=prefix_len, q0=q0, k0=k0, qb=qb,
                             kb=kb, fixed_kb=True)
    if impl == "auto":
        impl = "dense" if S * T <= 2048 * 2048 else "chunked"
    if impl == "dense":
        qpos = q0 + torch.arange(S, device=q.device)
        kpos = k0 + torch.arange(T, device=q.device)
        mask = tile_mask(kind, qpos, kpos, window=window, chunk=chunk,
                         prefix_len=prefix_len)[None]
        return _dense_core(q, k, v, mask.expand(B, S, T))
    if impl != "chunked":
        raise ValueError(f"unknown attention impl {impl!r}")
    return _chunked_core(q, k, v, kind=kind, window=window, chunk=chunk,
                         prefix_len=prefix_len, q0=q0, k0=k0, qb=qb, kb=kb)


# ---------------------------------------------------------------------------
# Projections (single layer and LP pair)
# ---------------------------------------------------------------------------

def pair_matmul(xs, w):
    """xs [2, ..., D] @ w [2, D, C] -> [2, ..., C]: one bmm over the pair
    axis with the other leading dims folded into rows. (A broadcast matmul
    against w[:, None] would copy the weights once per batch row.)"""
    y = torch.bmm(xs.reshape(2, -1, xs.shape[-1]), w)
    return y.reshape(*xs.shape[:-1], w.shape[-1])


def _proj(x, w, b):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _proj_pair(xs, w, b):
    """xs: [2,B,S,D] (per-path normalised inputs); w: [2,D,C] -> [2,B,S,C].
    One batched matmul for both paths == the paper's stacked projection."""
    y = pair_matmul(xs, w.to(xs.dtype))
    if b is not None:
        y = y + b[:, None, None, :].to(y.dtype)
    return y


def project_q(p, xn, cfg, dims: AttnDims, *, positions, kind, pair: bool):
    """q in folded layout [B,S,P*hq,hd]: the pair axis folds pair-major into
    the heads ([2, hq] per position, layer a first)."""
    bq = p.get("bq")
    if pair:
        B, S = xn.shape[1], xn.shape[2]
        q = _proj_pair(xn, p["wq"], bq)
        q = q.permute(1, 2, 0, 3).reshape(B, S, 2 * dims.hq, dims.hd)
    else:
        B, S = xn.shape[0], xn.shape[1]
        q = _proj(xn, p["wq"], bq).reshape(B, S, dims.hq, dims.hd)
    if _uses_rope(cfg, kind):
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def project_kv(p, xn, cfg, dims: AttnDims, *, positions, kind, pair: bool):
    """k, v in stored layout [B,S,P*hkv,hd] (pair folded into the heads)."""
    bk, bv = p.get("bk"), p.get("bv")
    if pair:
        B, S = xn.shape[1], xn.shape[2]
        k = _proj_pair(xn, p["wk"], bk).permute(1, 2, 0, 3).reshape(B, S, 2 * dims.hkv, dims.hd)
        v = _proj_pair(xn, p["wv"], bv).permute(1, 2, 0, 3).reshape(B, S, 2 * dims.hkv, dims.hd)
    else:
        B, S = xn.shape[0], xn.shape[1]
        k = _proj(xn, p["wk"], bk).reshape(B, S, dims.hkv, dims.hd)
        v = _proj(xn, p["wv"], bv).reshape(B, S, dims.hkv, dims.hd)
    if _uses_rope(cfg, kind):
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


# ---------------------------------------------------------------------------
# Decode (single new token against a ring KV cache)
# ---------------------------------------------------------------------------

def _widen(q, cache):
    """q in the wider of its type and the cache's: the decode kernels take
    one type, and bf16 q against an fp32 cache widens exactly. (The plain
    versions compute in fp32 whatever the types.)"""
    return q.to(torch.promote_types(q.dtype, cache.dtype))


def cache_slot(kind: str, t: int, *, window=0, chunk=0):
    """Ring-buffer slot + local validity horizon for a decode step ``t``:
    entries with index <= t_local are valid."""
    if kind == "attn_local" and window:
        return t % window, min(t, window - 1)
    if kind == "attn_chunked" and chunk:
        return t % chunk, t % chunk
    return t, t


def decode_attn_standard(p, xn, cache_k, cache_v, t: int, cfg, dims: AttnDims,
                         *, kind, pair: bool, window=0, chunk=0):
    """Decode with head-local ring caches. Returns (partial_out, cache_k,
    cache_v); the caches are the SAME tensors, updated in place.

    pair=False: xn [B,1,D], cache_[kv] [B, L, hkv, hd].
    pair=True (fused LP pair): xn [2,B,1,D], cache_[kv] [2, B, L, hkv, hd]
    stacked-contiguous. Both layers run as one wide unit: one stacked QKV
    projection, one slot write per cache tensor, one decode attention launch
    over both halves, one merged output projection.
    """
    B = xn.shape[1] if pair else xn.shape[0]
    pos = torch.full((1,), t, dtype=torch.int64, device=xn.device)
    q = project_q(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    k, v = project_kv(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    slot, t_local = cache_slot(kind, t, window=window, chunk=chunk)
    Hk, g = dims.hkv, dims.group

    if pair:
        # New-token kv arrives pair-folded [B,1,2*hkv,hd]; unfold to the
        # stacked layout and write both layers' slots in one assignment.
        k2 = k.reshape(B, 1, 2, Hk, dims.hd).permute(2, 0, 1, 3, 4)
        v2 = v.reshape(B, 1, 2, Hk, dims.hd).permute(2, 0, 1, 3, 4)
        cache_k[:, :, slot:slot + 1] = k2.to(cache_k.dtype)
        cache_v[:, :, slot:slot + 1] = v2.to(cache_v.dtype)
        qh = q.reshape(B, 2, Hk, g, dims.hd).transpose(0, 1)  # [2,B,Hk,g,hd]
        o = ops.decode_attention_pair(_widen(qh, cache_k), cache_k, cache_v,
                                      t_local).to(xn.dtype)
        o = o.transpose(0, 1).reshape(B, 1, 2 * dims.hq, dims.hd)
        return output_proj(p, o, dims, pair=True), cache_k, cache_v

    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    qh = _widen(q.reshape(B, Hk, g, dims.hd), cache_k)
    o = ops.decode_attention(qh, cache_k, cache_v, t_local).to(xn.dtype)
    o = o.reshape(B, 1, dims.hq, dims.hd)
    return output_proj(p, o, dims, pair=False), cache_k, cache_v


def decode_attn_paged(p, xn, k_pages, v_pages, t, block_tables, cfg,
                      dims: AttnDims, *, kind, pair: bool):
    """Decode against the PAGED pool (continuous batching). Returns
    (partial_out, k_pages, v_pages); the pools are the SAME tensors,
    updated in place.

    pair=False: xn [B,1,D], k/v_pages [n_pages, ps, hkv, hd].
    pair=True (fused LP pair): xn [2,B,1,D], k/v_pages [2, n_pages, ps,
    hkv, hd] stacked-contiguous — both halves occupy the same page indices
    of their own half, so one block table serves the pair: one projection,
    one scatter per pool tensor, one attention launch, one merged output
    projection.

    t: [B] int32 per-slot positions; block_tables: [B, n_pg] int32, with
    unused entries and idle slots' whole rows at the reserved garbage page
    0. Idle slots all write (page 0, offset 0); with duplicate indices the
    write that lands there is unspecified, and nothing reads page 0
    unmasked. Only plain causal kinds page (slot == t).
    """
    B = xn.shape[1] if pair else xn.shape[0]
    q = project_q(p, xn, cfg, dims, positions=t[:, None], kind=kind, pair=pair)
    k, v = project_kv(p, xn, cfg, dims, positions=t[:, None], kind=kind,
                      pair=pair)
    ps = k_pages.shape[2 if pair else 1]
    tl = t.long()
    # Indirection: position t lives at (bt[b, t // ps], t % ps).
    page_of = block_tables.long().gather(1, (tl // ps)[:, None])[:, 0]
    off = tl % ps
    Hk, g = dims.hkv, dims.group

    if pair:
        # New-token kv arrives pair-folded [B,1,2*hkv,hd]; unfold and write
        # both halves' (page, offset) in one scatter per pool tensor.
        k2 = k.reshape(B, 2, Hk, dims.hd).transpose(0, 1)
        v2 = v.reshape(B, 2, Hk, dims.hd).transpose(0, 1)
        k_pages[:, page_of, off] = k2.to(k_pages.dtype)
        v_pages[:, page_of, off] = v2.to(v_pages.dtype)
        qh = q.reshape(B, 2, Hk, g, dims.hd).transpose(0, 1)  # [2,B,Hk,g,hd]
        o = ops.decode_attention_pair_paged(_widen(qh, k_pages), k_pages,
                                            v_pages, block_tables,
                                            t).to(xn.dtype)
        o = o.transpose(0, 1).reshape(B, 1, 2 * dims.hq, dims.hd)
        return output_proj(p, o, dims, pair=True), k_pages, v_pages

    k_pages[page_of, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page_of, off] = v[:, 0].to(v_pages.dtype)
    qh = _widen(q.reshape(B, Hk, g, dims.hd), k_pages)
    o = ops.decode_attention_paged(qh, k_pages, v_pages, block_tables,
                                   t).to(xn.dtype)
    o = o.reshape(B, 1, dims.hq, dims.hd)
    return output_proj(p, o, dims, pair=False), k_pages, v_pages


def output_proj(p, o, dims: AttnDims, *, pair: bool):
    """o: [B,S,P*hq,hd] -> partial [B,S,D] (caller runs phase_out)."""
    B, S = o.shape[0], o.shape[1]
    if pair:
        # Per-path gemms + one explicit add: pins the reduction grouping.
        o2 = o.reshape(B, S, 2, dims.hq * dims.hd)
        wo = p["wo"].to(o.dtype)
        y = o2[:, :, 0] @ wo[0] + o2[:, :, 1] @ wo[1]
    else:
        y = o.reshape(B, S, dims.hq * dims.hd) @ p["wo"].to(o.dtype)
    if p.get("bo") is not None:
        bo = p["bo"].float()
        if pair:
            bo = bo.sum(dim=0)  # both paths' biases enter the one reduction
        y = y + bo.to(y.dtype)
    return y
