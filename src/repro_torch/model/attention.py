"""Multi-head attention mixers: projections, cores and ring-cache decode.

The JAX package's conventions carry over unchanged: q heads in the grouped
layout [B,S,Hk,g,hd] (g query heads per kv head), LP pairs as a leading pair
axis on the weights with the pair folded pair-major into the head axis, and
the pair's output projection as per-path gemms plus one add.

Tensor parallelism (JAX's conventions, per rank):
  * q heads are padded to a multiple of tp (zero ``wo`` rows make the
    padded heads inert) and split over the ranks: hq = hq_global // tp;
  * kv heads are split when n_kv >= tp (padded likewise), and replicated
    otherwise: every rank projects and stores all n_kv heads and selects
    the one its q heads read (``select_local_kv``: a view of one head),
    or, where the rank's q heads span kv groups, one kv head per q head
    (``per_head``: a gather). The paged decode kernel takes that selection
    as its head map (``paged_head_map``), so the pool is never copied;
  * ``wo`` splits its rows, so each rank returns a partial sum (with
    ``bo / tp``) that the caller's phase_out adds up.

Kernels: on a CUDA tensor ``attention_core`` runs the flash kernel for every
impl (a pinned ``"chunked:<kb>"`` becomes its fixed kv tile width),
``decode_attn_standard`` runs the ring decode kernel and
``decode_attn_paged`` the paged one, each one launch for both halves of a
pair. On a CPU tensor the impls are the plain cores below and decode runs
the kernel's plain version. Decode updates the cache in place: the new
token's k/v are index-assigned into the stored ring cache or page pool.

``decode_attn_seq_sharded`` (the sequence-sharded ring, ``kv_mode="seq"``)
has no kernel, in the JAX package either: its core is torch ops on every
device, and it calls no ``ops`` wrapper.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.model.params import PD
from repro_torch.model.rope import apply_rope
from repro_torch.parallel.context import ParallelContext

NEG_INF = -1e30

#: kv tile width of the flash kernel for impls that do not pin one.
FLASH_BLOCK_N = 64


# ---------------------------------------------------------------------------
# Static dimension bookkeeping
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AttnDims:
    tp: int
    hq_global: int      # padded global q heads
    hq: int             # local q heads
    kv_sharded: bool
    hkv_global: int     # stored global kv heads (padded when split)
    hkv: int            # kv heads each rank stores (all n_kv when replicated)
    group: int          # ORIGINAL q heads per kv head (GQA group)
    hd: int
    per_head: bool = False  # rank q heads span kv groups: one kv head each


def attn_dims(cfg, tp: int) -> AttnDims:
    """Head counts per rank under ``tp``-way tensor parallelism, as the
    JAX package's ``attn_dims``."""
    if cfg.n_heads == 0:  # attention-free arch (falcon-mamba)
        return AttnDims(tp, 0, 0, False, 0, 0, 1, cfg.head_dim or 1)
    hq_global = -(-cfg.n_heads // tp) * tp
    hq = hq_global // tp
    kv_sharded = cfg.n_kv_heads >= tp
    per_head = False
    if kv_sharded:
        hkv_global = -(-cfg.n_kv_heads // tp) * tp
        hkv = hkv_global // tp
        assert hq % hkv == 0, (hq, hkv)
    else:
        hkv_global = hkv = cfg.n_kv_heads
    group = max(cfg.n_heads // max(cfg.n_kv_heads, 1), 1)
    if not kv_sharded and tp > 1 and group % hq != 0:
        # The rank's q heads span GQA groups: it reads one kv head per q
        # head (g = 1).
        per_head = True
    return AttnDims(tp, hq_global, hq, kv_sharded, hkv_global, hkv, group,
                    cfg.head_dim, per_head)


def attn_template(cfg, tp: int):
    d = attn_dims(cfg, tp)
    D = cfg.d_model
    kv = 1 if d.kv_sharded else None   # kv columns split, or replicated
    t = {
        "wq": PD((D, d.hq_global * d.hd), split=1),
        "wk": PD((D, d.hkv_global * d.hd), split=kv),
        "wv": PD((D, d.hkv_global * d.hd), split=kv),
        "wo": PD((d.hq_global * d.hd, D), split=0),
    }
    if getattr(cfg, "attn_bias", False):
        kvb = 0 if d.kv_sharded else None
        t["bq"] = PD((d.hq_global * d.hd,), init="zeros", split=0)
        t["bk"] = PD((d.hkv_global * d.hd,), init="zeros", split=kvb)
        t["bv"] = PD((d.hkv_global * d.hd,), init="zeros", split=kvb)
        t["bo"] = PD((D,), init="zeros")
    return t


# ---------------------------------------------------------------------------
# The rank's kv heads
# ---------------------------------------------------------------------------

def rank_head_kv_map(dims: AttnDims, pc: ParallelContext) -> Tuple[int, ...]:
    """The kv head each of this rank's q heads reads (per-head mode).
    Padded q heads clip to the last kv head (their wo rows are zero)."""
    base = pc.tp_index() * dims.hq
    return tuple(min((base + i) // dims.group, dims.hkv - 1)
                 for i in range(dims.hq))


def _rank_kv_head(dims: AttnDims, pc: ParallelContext) -> int:
    """The one kv head of a rank whose q heads lie in one GQA group."""
    return min(pc.tp_index() * dims.hq // dims.group, dims.hkv - 1)


def select_local_kv(kv, dims: AttnDims, pc: ParallelContext, *,
                    head_axis: int = 2):
    """kv as stored (head axis ``head_axis``) -> the rank's kv heads for
    the grouped core: all of them when kv is split (or tp 1); the rank's
    one kv head when replicated (a view); one per q head in per-head mode
    (a gather)."""
    if dims.kv_sharded or dims.tp == 1:
        return kv
    if dims.per_head:
        idx = torch.tensor(rank_head_kv_map(dims, pc), device=kv.device)
        return kv.index_select(head_axis, idx)
    return kv.narrow(head_axis, _rank_kv_head(dims, pc), 1)


def select_local_kv_pair(kv, dims: AttnDims, pc: ParallelContext):
    """Stacked-pair form: kv [2,B,T,hkv,hd] -> [2,B,T,Hk,hd], the same
    selection on head axis 3, so the pair stays one tensor."""
    return select_local_kv(kv, dims, pc, head_axis=3)


def paged_head_map(dims: AttnDims, pc: ParallelContext) -> Optional[Tuple[int, ...]]:
    """The paged decode kernel's head map (q's local kv head -> the pool's
    stored head), or None for the identity (tp 1, or kv split: the rank's
    pool holds exactly its heads). ``select_local_kv`` as an index map:
    [hq] in per-head mode (g = 1), else [1] (g = hq)."""
    if dims.tp == 1 or dims.kv_sharded:
        return None
    if dims.per_head:
        return rank_head_kv_map(dims, pc)
    return (_rank_kv_head(dims, pc),)


@functools.lru_cache(maxsize=None)
def _head_map_tensor(hm: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """One int32 tensor per (map, device), so a decode step uploads no map
    and the kernel wrapper checks each map's entries once."""
    return torch.tensor(hm, dtype=torch.int32, device=device)


def core_layout(dims: AttnDims) -> Tuple[int, int]:
    """(Hk, g) of the grouped core for one layer's local heads."""
    if dims.tp == 1 or dims.kv_sharded:
        assert dims.hq % dims.hkv == 0, (dims.hq, dims.hkv)
        return dims.hkv, dims.hq // dims.hkv
    if dims.per_head:
        return dims.hq, 1   # one gathered kv head per q head
    return 1, dims.hq       # replicated kv: the rank's one kv head, g = hq


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
                   q0=0, k0=0, impl="auto", qb=512, kb=1024,
                   differentiable=False):
    """Grouped attention: q [B,S,Hk,g,hd]; k, v [B,T,Hk,hd] -> q's shape.

    impl: "auto" | "dense" | "chunked" | "chunked:<kb>" (pinned kv tile
    width) | "flash". On a CUDA tensor every impl launches the flash kernel,
    with the pinned width of "chunked:<kb>" as its kv tile. On a CPU tensor
    "flash" runs the kernel wrapper's plain version (the kernel's layout
    and fold, for tests) and the others run the plain cores.

    ``differentiable`` (the train step's forward): the plain torch cores
    on any device, chosen by ``impl`` as on the CPU, so autograd sees the
    whole product (the flash kernel has no backward); "flash" raises.

    ``q0`` may be an int32 [B] tensor of per-row offsets; then the impl
    must pin its tile ("chunked:<kb>") or be the flash kernel."""
    B, S, Hk, g, hd = q.shape
    T = k.shape[1]
    pinned = impl.startswith("chunked:")
    if differentiable and impl == "flash":
        raise ValueError("impl='flash' is the kernel, which has no backward; "
                         "the differentiable forward takes a torch core")
    kernel = not differentiable and (q.device.type != "cpu" or impl == "flash")
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
    if impl == "auto":   # on meta (the dry run) the dense core: shapes only
        impl = ("dense" if S * T <= 2048 * 2048 or q.device.type == "meta"
                else "chunked")
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
                         *, kind, pair: bool, window=0, chunk=0,
                         pc: Optional[ParallelContext] = None):
    """Decode with head-local ring caches. Returns (partial_out, cache_k,
    cache_v); the caches are the SAME tensors, updated in place.

    pair=False: xn [B,1,D], cache_[kv] [B, L, hkv, hd].
    pair=True (fused LP pair): xn [2,B,1,D], cache_[kv] [2, B, L, hkv, hd]
    stacked-contiguous. Both layers run as one wide unit: one stacked QKV
    projection, one slot write per cache tensor, one decode attention launch
    over both halves, one merged output projection.

    ``pc`` (tp > 1): the cache holds the rank's stored kv heads, and the
    kernel reads the rank's selection of them (``select_local_kv``: a view
    of one head, or a gather in per-head mode).
    """
    pc = _context(pc, dims)
    B = xn.shape[1] if pair else xn.shape[0]
    pos = torch.full((1,), t, dtype=torch.int64, device=xn.device)
    q = project_q(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    k, v = project_kv(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    slot, t_local = cache_slot(kind, t, window=window, chunk=chunk)
    Hk, g = core_layout(dims)

    if pair:
        # New-token kv arrives pair-folded [B,1,2*hkv,hd]; unfold to the
        # stacked layout and write both layers' slots in one assignment.
        k2 = k.reshape(B, 1, 2, dims.hkv, dims.hd).permute(2, 0, 1, 3, 4)
        v2 = v.reshape(B, 1, 2, dims.hkv, dims.hd).permute(2, 0, 1, 3, 4)
        cache_k[:, :, slot:slot + 1] = k2.to(cache_k.dtype)
        cache_v[:, :, slot:slot + 1] = v2.to(cache_v.dtype)
        ks = select_local_kv_pair(cache_k, dims, pc)          # [2,B,L,Hk,hd]
        vs = select_local_kv_pair(cache_v, dims, pc)
        qh = q.reshape(B, 2, Hk, g, dims.hd).transpose(0, 1)  # [2,B,Hk,g,hd]
        o = ops.decode_attention_pair(_widen(qh, cache_k), ks, vs,
                                      t_local).to(xn.dtype)
        o = o.transpose(0, 1).reshape(B, 1, 2 * dims.hq, dims.hd)
        return output_proj(p, o, dims, pair=True), cache_k, cache_v

    cache_k[:, slot:slot + 1] = k.to(cache_k.dtype)
    cache_v[:, slot:slot + 1] = v.to(cache_v.dtype)
    ks = select_local_kv(cache_k, dims, pc)
    vs = select_local_kv(cache_v, dims, pc)
    qh = _widen(q.reshape(B, Hk, g, dims.hd), cache_k)
    o = ops.decode_attention(qh, ks, vs, t_local).to(xn.dtype)
    o = o.reshape(B, 1, dims.hq, dims.hd)
    return output_proj(p, o, dims, pair=False), cache_k, cache_v


def decode_attn_seq_sharded(p, xn, cache_k, cache_v, t: int, cfg,
                            dims: AttnDims, *, kind, pair: bool, window=0,
                            chunk=0, pc: Optional[ParallelContext] = None):
    """Decode with the ring cache cut along the SEQUENCE over the ranks
    (replicated kv heads, fewer than the ranks: each rank stores L/tp
    positions of every kv head instead of all L). Returns (partial_out,
    cache_k, cache_v); the caches are the SAME tensors, updated in place.

    pair=False: xn [B,1,D], cache_[kv] [B, L/tp, n_kv, hd]; pair=True:
    xn [2,B,1,D], cache_[kv] [2, B, L/tp, n_kv, hd] stacked, both layers
    in one evaluation. Every rank's q heads are gathered (``all_gather_tp``,
    rank-major), the new token's k/v land only on the rank that holds slot
    ``t``, each rank takes the partial softmax of all q heads over its
    positions, and one ``pmax_tp`` plus ONE packed ``psum_tp`` of (acc, l)
    combine them, whatever the pair width; the rank's q heads are sliced
    back out for its output projection. Torch ops on every device: the
    JAX package runs this core in XLA, with no kernel."""
    pc = _context(pc, dims)
    nP = 2 if pair else 1
    B = xn.shape[1] if pair else xn.shape[0]
    tp, rank, hd = dims.tp, pc.tp_index(), dims.hd
    pos = torch.full((1,), t, dtype=torch.int64, device=xn.device)
    q = project_q(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    k, v = project_kv(p, xn, cfg, dims, positions=pos, kind=kind, pair=pair)
    qg = pc.all_gather_tp(q, axis=2)            # [B,1,tp*nP*hq,hd] rank-major
    qg = qg.reshape(B, tp, nP, dims.hq, hd).transpose(1, 2)  # [B,nP,tp,hq,hd]

    # Only the rank that holds slot ``t`` writes the new token's k/v.
    slot, t_local = cache_slot(kind, t, window=window, chunk=chunk)
    seq_ax = 2 if pair else 1
    L_loc, n_kv = cache_k.shape[seq_ax], cache_k.shape[seq_ax + 1]
    local_slot = slot - rank * L_loc
    if 0 <= local_slot < L_loc:
        if pair:   # the pair-folded new token to the stacked layout
            kn = k.reshape(B, 1, 2, n_kv, hd).permute(2, 0, 1, 3, 4)
            vn = v.reshape(B, 1, 2, n_kv, hd).permute(2, 0, 1, 3, 4)
            cache_k[:, :, local_slot:local_slot + 1] = kn.to(cache_k.dtype)
            cache_v[:, :, local_slot:local_slot + 1] = vn.to(cache_v.dtype)
        else:
            cache_k[:, local_slot:local_slot + 1] = k.to(cache_k.dtype)
            cache_v[:, local_slot:local_slot + 1] = v.to(cache_v.dtype)

    Hq_all = tp * dims.hq                       # the padded global q heads
    ks = cache_k if pair else cache_k[None]     # [nP,B,L_loc,n_kv,hd]
    vs = cache_v if pair else cache_v[None]
    if dims.per_head or Hq_all != dims.group * n_kv:
        # One kv head per q head by the TRUE head -> kv map: head i reads
        # i // group, clipped (padded q heads; their wo rows are zero).
        hmap = torch.clamp(torch.arange(Hq_all, device=ks.device) // dims.group,
                           max=n_kv - 1)
        ks, vs = ks.index_select(3, hmap), vs.index_select(3, hmap)
        n_eff, g = Hq_all, 1
    else:
        n_eff, g = n_kv, Hq_all // max(n_kv, 1)
    qh = qg.reshape(B, nP, n_eff, g, hd)

    s = torch.einsum("bpngh,pbtnh->bpngt", qh.float(), ks.float()) * hd ** -0.5
    gpos = rank * L_loc + torch.arange(L_loc, device=s.device)
    s = torch.where(gpos <= t_local, s, NEG_INF)
    m = pc.pmax_tp(s.amax(dim=-1))
    pexp = torch.exp(s - m[..., None])
    acc = torch.einsum("bpngt,pbtnh->bpngh", pexp, vs.float())
    packed = pc.psum_tp(torch.cat([acc, pexp.sum(dim=-1)[..., None]], dim=-1))
    acc, l = packed[..., :-1], packed[..., -1]
    o_all = (acc / torch.clamp_min(l, 1e-30)[..., None]).reshape(B, nP, Hq_all, hd)
    o = o_all[:, :, rank * dims.hq:(rank + 1) * dims.hq]  # the rank's q heads
    o = o.reshape(B, 1, nP * dims.hq, hd)                 # pair-major
    return output_proj(p, o, dims, pair=pair), cache_k, cache_v


def decode_attn_paged(p, xn, k_pages, v_pages, t, block_tables, cfg,
                      dims: AttnDims, *, kind, pair: bool,
                      pc: Optional[ParallelContext] = None):
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

    ``pc`` (tp > 1): a split-kv pool holds the rank's heads (no map); a
    replicated pool holds every stored head, and the kernel reads the
    rank's through its head map (``paged_head_map``), with no copy.
    """
    pc = _context(pc, dims)
    B = xn.shape[1] if pair else xn.shape[0]
    q = project_q(p, xn, cfg, dims, positions=t[:, None], kind=kind, pair=pair)
    k, v = project_kv(p, xn, cfg, dims, positions=t[:, None], kind=kind,
                      pair=pair)
    ps = k_pages.shape[2 if pair else 1]
    tl = t.long()
    # Indirection: position t lives at (bt[b, t // ps], t % ps).
    page_of = block_tables.long().gather(1, (tl // ps)[:, None])[:, 0]
    off = tl % ps
    Hk, g = core_layout(dims)
    hm = paged_head_map(dims, pc)
    if hm is not None:
        hm = _head_map_tensor(hm, k_pages.device)

    if pair:
        # New-token kv arrives pair-folded [B,1,2*hkv,hd]; unfold and write
        # both halves' (page, offset) in one scatter per pool tensor.
        k2 = k.reshape(B, 2, dims.hkv, dims.hd).transpose(0, 1)
        v2 = v.reshape(B, 2, dims.hkv, dims.hd).transpose(0, 1)
        k_pages[:, page_of, off] = k2.to(k_pages.dtype)
        v_pages[:, page_of, off] = v2.to(v_pages.dtype)
        qh = q.reshape(B, 2, Hk, g, dims.hd).transpose(0, 1)  # [2,B,Hk,g,hd]
        o = ops.decode_attention_pair_paged(_widen(qh, k_pages), k_pages,
                                            v_pages, block_tables, t,
                                            hm).to(xn.dtype)
        o = o.transpose(0, 1).reshape(B, 1, 2 * dims.hq, dims.hd)
        return output_proj(p, o, dims, pair=True), k_pages, v_pages

    k_pages[page_of, off] = k[:, 0].to(k_pages.dtype)
    v_pages[page_of, off] = v[:, 0].to(v_pages.dtype)
    qh = _widen(q.reshape(B, Hk, g, dims.hd), k_pages)
    o = ops.decode_attention_paged(qh, k_pages, v_pages, block_tables, t,
                                   hm).to(xn.dtype)
    o = o.reshape(B, 1, dims.hq, dims.hd)
    return output_proj(p, o, dims, pair=False), k_pages, v_pages


def _context(pc: Optional[ParallelContext], dims: AttnDims) -> ParallelContext:
    """The caller's context; None only at tp 1."""
    if pc is None:
        if dims.tp != 1:
            raise ValueError(f"tp={dims.tp} heads need the rank's ParallelContext")
        return ParallelContext()
    if pc.tp_size != dims.tp:
        raise ValueError(f"a tp_size={pc.tp_size} context for tp={dims.tp} heads")
    return pc


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
        y = y + (bo / dims.tp).to(y.dtype)   # each rank's share of the sum
    return y
