"""Layer and LP-pair application (attention + MLP groups, Mamba groups).

A ``Group`` is either one layer or an LP pair of two consecutive layers. The
pair path is the paper's Fig. 2b rewrite:

    a = x + A_k(LN1_k x) + A_{k+1}(LN1_{k+1} x)     # ONE phase_out
    y = a + F_k(LN2_k a) + F_{k+1}(LN2_{k+1} a)     # ONE phase_out

Pair params are the two layers' params stacked on a leading axis. A pair
whose halves share one mixer kind stores its decode caches stacked on a
leading pair axis — ``k``/``v``: [2, B, L, Hkv, hd] under bare names, while
single layers keep indexed names ``k0``/``v0`` — and decodes as ONE call
into ``attention.decode_attn_standard(pair=True)``, or
``decode_attn_paged(pair=True)`` over the engine's page pool. Decode
updates the caches in place.

A Mamba group (falcon-mamba: one mixer per layer, no FFN) runs its phase
through ``ssm.ssm_mix`` with the pair's paths on one leading axis. Its
decode state is the conv window ``conv`` [B, K-1, d_inner] in the cache
type and the recurrent state ``h`` [B, d_inner, N] in fp32, stacked on the
pair axis under bare names like k/v (``conv0``/``h0`` for a single layer),
and updated in place.

Ported so far: attention mixers with an MLP, and Mamba mixers. RG-LRU,
MoE, cross-attention and pairs of mixed mixer kinds raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.model import attention as A
from repro_torch.model import mlp as M
from repro_torch.model import ssm as SSM
from repro_torch.model.norms import apply_norm, dual_norm
from repro_torch.model.params import PD, tree_map
from repro_torch.parallel.context import ParallelContext


@dataclass(frozen=True)
class Group:
    pair: bool
    specs: Tuple[LayerSpec, ...]      # 1 or 2 entries
    layer_ids: Tuple[int, ...]

    @property
    def signature(self):
        return (self.pair, self.specs)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet (the port runs "
                               "attention + MLP layers and Mamba layers)")


# ---------------------------------------------------------------------------
# Templates
# ---------------------------------------------------------------------------

def _norm_tmpl(cfg):
    t = {"scale": PD((cfg.d_model,),
                     init="zeros" if cfg.norm_plus_one else "ones")}
    if cfg.norm_kind == "layernorm":
        t["bias"] = PD((cfg.d_model,), init="zeros")
    return t


def layer_template(cfg: ArchConfig, spec: LayerSpec, tp: int):
    if spec.cross_attn:
        raise _not_ported("cross-attention")
    t: Dict[str, Any] = {"ln1": _norm_tmpl(cfg)}
    if spec.mixer.startswith("attn"):
        t["attn"] = A.attn_template(cfg, tp)
    elif spec.mixer == "mamba":
        t["mamba"] = SSM.ssm_template(cfg, tp)
    else:
        raise _not_ported(f"mixer {spec.mixer!r}")
    if spec.ffn == "mlp":
        t["ln2"] = _norm_tmpl(cfg)
        t["mlp"] = M.mlp_template(cfg, tp)
    elif spec.ffn is not None:
        raise _not_ported(f"ffn {spec.ffn!r}")
    return t


# ---------------------------------------------------------------------------
# Phase runners
# ---------------------------------------------------------------------------

def _norm_inputs(gp, key, x, cfg, group: Group):
    """Per-path normalised inputs: [B,S,D] (single) or [2,B,S,D] (pair)."""
    if group.pair:
        return dual_norm(x, tree_map(lambda v: v[0], gp[key]),
                         tree_map(lambda v: v[1], gp[key]), cfg)
    return apply_norm(x, gp[key], cfg)


def _homogeneous_kind(group: Group) -> str:
    kinds = {s.mixer for s in group.specs}
    if len(kinds) != 1:
        raise _not_ported(f"a pair of mixed mixer kinds {sorted(kinds)}")
    return kinds.pop()


def attention_phase_full(gp, xn, cfg, dims, *, group: Group, positions,
                         attn_impl="auto", ctx_kv=None, q0=0):
    """Full-sequence attention (prefill). Returns (partial_out, kv_list)
    with one (k, v) in stored layout per layer in the group.

    ``ctx_kv`` (suffix prefill, prefix sharing): this group's cached
    CONTEXT keys/values for absolute positions [0, q0), in stored layout
    ({"k"/"v"}: [2,B,Tc,hkv,hd] stacked pair, {"k0"/"v0"}: [B,Tc,hkv,hd]
    single layer; keys already roped). They are put before the suffix's
    fresh kv, so every suffix row reduces over exactly ``q0 + S`` keys: the
    reduction shape the full-prompt forward gives that row. ``q0`` is the
    absolute position of the first query row: an int, or a [B] tensor of
    per-row context lengths (bucketed radix-hit rows)."""
    kind = _homogeneous_kind(group)
    p = gp["attn"]
    B = xn.shape[1] if group.pair else xn.shape[0]
    S = xn.shape[2] if group.pair else xn.shape[1]
    nP = 2 if group.pair else 1
    q = A.project_q(p, xn, cfg, dims, positions=positions, kind=kind,
                    pair=group.pair)
    k, v = A.project_kv(p, xn, cfg, dims, positions=positions, kind=kind,
                        pair=group.pair)
    ks, vs = k, v
    if ctx_kv is not None:
        cks, cvs = _fold_ctx_kv(ctx_kv, dims, group=group)
        ks = torch.cat([cks.to(k.dtype), k], dim=1)
        vs = torch.cat([cvs.to(v.dtype), v], dim=1)
        if torch.is_tensor(q0):
            # Per-row ctx lengths: row i's real context is the first q0[i]
            # positions of the Tc-wide ctx block, the rest garbage-page
            # filler. Rearrange each row's keys to [real ctx | suffix |
            # junk], so every real key sits at its absolute position and
            # the junk lands at kpos >= q0[i] + S, past the row's last query,
            # where the causal mask kills it. With the pinned kv tile the
            # junk is then bit-transparent like bucket padding: a ctx row
            # reduces as the cold full-prompt program does, and a row with
            # q0[i] = 0 as the plain bucket program does (attention_core
            # refuses a per-row q0 to an impl without a pinned tile).
            Tc, Tt = cks.shape[1], ks.shape[1]
            j = torch.arange(Tt, device=ks.device)[None, :]
            c = q0.long()[:, None]
            idx = torch.where(j < c, j, torch.where(j < c + S, Tc + (j - c), j - S))
            idx = idx[:, :, None, None].expand(-1, -1, *ks.shape[2:])
            ks = torch.gather(ks, 1, idx)
            vs = torch.gather(vs, 1, idx)
        # torch.cat and torch.gather materialise the keys and values before
        # the core, so the value contraction runs over one tensor and its
        # float accumulation is grouped as in the cold full-prompt forward.
    # Pair-major folds: q heads [2*hq] group onto kv heads [2*hkv].
    qh = q.reshape(B, S, nP * dims.hkv, dims.group, dims.hd)
    o = A.attention_core(qh, ks, vs, kind=kind, window=cfg.window,
                         chunk=cfg.chunk, q0=q0, impl=attn_impl)
    o = o.reshape(B, S, nP * dims.hq, dims.hd)
    out = A.output_proj(p, o, dims, pair=group.pair)
    return out, _split_kv(k, v, dims, pair=group.pair)


def _fold_ctx_kv(ctx_kv, dims, *, group: Group):
    """Cached context kv (stored layout) -> the folded [B,Tc,P*hkv,hd]
    layout of fresh projections, so a suffix forward can put context before
    suffix keys along the length axis. The pair fold is pair-major, as
    ``project_kv``'s."""
    if group.pair:
        ck, cv = ctx_kv["k"], ctx_kv["v"]              # [2,B,Tc,hkv,hd]
        B, Tc = ck.shape[1], ck.shape[2]
        return (ck.movedim(0, 2).reshape(B, Tc, 2 * dims.hkv, dims.hd),
                cv.movedim(0, 2).reshape(B, Tc, 2 * dims.hkv, dims.hd))
    return ctx_kv["k0"], ctx_kv["v0"]                  # [B,Tc,hkv,hd]


def _split_kv(k, v, dims, *, pair: bool):
    if not pair:
        return [(k, v)]
    B, S = k.shape[0], k.shape[1]
    k2 = k.reshape(B, S, 2, dims.hkv, dims.hd)
    v2 = v.reshape(B, S, 2, dims.hkv, dims.hd)
    return [(k2[:, :, 0], v2[:, :, 0]), (k2[:, :, 1], v2[:, :, 1])]


def ffn_phase(gp, xn, cfg, pc, *, group: Group):
    """Returns (partial_out, aux)."""
    ffn = group.specs[0].ffn
    if ffn != "mlp":
        raise _not_ported(f"ffn {ffn!r}")
    return M.mlp_forward(gp["mlp"], xn, cfg, pc.tp_size, pair=group.pair), 0.0


# ---------------------------------------------------------------------------
# KV-cache construction
# ---------------------------------------------------------------------------

def ring_len(cfg, mixer: str, max_len: int) -> int:
    if mixer == "attn_local" and cfg.window:
        return min(cfg.window, max_len)
    if mixer == "attn_chunked" and cfg.chunk:
        return min(cfg.chunk, max_len)
    return max_len


def fill_cache(k, L: int, *, mixer, cfg):
    """Place prefill keys/values [B,S,hkv,hd] into a decode ring cache."""
    B, S, H, hd = k.shape
    if mixer == "attn_local" and cfg.window and S >= (W := ring_len(cfg, mixer, L)):
        return torch.roll(k[:, S - W:], (S - W) % W, dims=1)
    if mixer == "attn_chunked" and cfg.chunk:
        C = ring_len(cfg, mixer, L)
        cstart = (S // C) * C if S % C else S  # S%C==0 -> empty fresh chunk
        ring = torch.zeros((B, C, H, hd), dtype=k.dtype, device=k.device)
        ring[:, :S - cstart] = k[:, cstart:]
        return ring
    Ls = ring_len(cfg, mixer, L)
    kp = torch.zeros((B, Ls, H, hd), dtype=k.dtype, device=k.device)
    n = min(S, Ls)
    kp[:, :n] = k[:, :n]
    return kp


def group_cache_meta(cfg, group: Group, dims, *, batch: int, max_len: int,
                     dtype=torch.bfloat16):
    """{entry name: (shape, dtype)} for one group's decode cache. A pair
    stores one stacked entry per tensor under a bare name ("k", "v"; "conv",
    "h") with a leading pair axis of 2; a single layer keeps indexed names
    ("k0", "v0"; "conv0", "h0"). The Mamba state ``h`` is fp32 whatever the
    cache type."""
    mixer = _homogeneous_kind(group)
    if mixer.startswith("attn"):
        shp = (batch, ring_len(cfg, mixer, max_len), dims.hkv, dims.hd)
        entries = {"k": (shp, dtype), "v": (shp, dtype)}
    elif mixer == "mamba":
        di = cfg.d_inner
        entries = {"conv": ((batch, cfg.ssm_conv - 1, di), dtype),
                   "h": ((batch, di, cfg.ssm_state), torch.float32)}
    else:
        raise _not_ported(f"mixer {mixer!r}")
    if group.pair:
        return {name: ((2, *shp), dt) for name, (shp, dt) in entries.items()}
    return {f"{name}0": spec for name, spec in entries.items()}


# ---------------------------------------------------------------------------
# Full-sequence group application (prefill)
# ---------------------------------------------------------------------------

def apply_group_full(gp, x, *, cfg, group: Group, dims, pc: ParallelContext,
                     positions, attn_impl="auto", emit_cache=False, max_len=0,
                     ctx_kv=None, q0=0):
    """One group over the full sequence. x: [B,S,D]. Returns (x, aux,
    cache_dict).

    ``ctx_kv``/``q0`` (suffix prefill): cached kv for positions [0, q0) in
    stored layout; the sequence starts at absolute position ``q0``. The
    emitted cache covers only the suffix (length ``max_len``, local 0 ==
    absolute ``q0``); the caller places it after the context."""
    cache: Dict[str, Any] = {}
    mixer = _homogeneous_kind(group)

    # ---- phase 1: the mixer ---------------------------------------------
    xn = _norm_inputs(gp, "ln1", pc.phase_in(x), cfg, group)
    if mixer.startswith("attn"):
        out, kvs = attention_phase_full(gp, xn, cfg, dims, group=group,
                                        positions=positions,
                                        attn_impl=attn_impl, ctx_kv=ctx_kv,
                                        q0=q0)
        if emit_cache:
            fks = [fill_cache(k, max_len, mixer=mixer, cfg=cfg) for k, _ in kvs]
            fvs = [fill_cache(v, max_len, mixer=mixer, cfg=cfg) for _, v in kvs]
            if group.pair:  # stacked-contiguous layout for the fused decode
                cache["k"], cache["v"] = torch.stack(fks), torch.stack(fvs)
            else:
                cache["k0"], cache["v0"] = fks[0], fvs[0]
    elif mixer == "mamba":
        if ctx_kv is not None:
            raise NotImplementedError(
                "suffix prefill needs attention mixers (recurrent state "
                "cannot resume from cached kv)")
        out, (conv, h) = SSM.ssm_mix(_mamba_params(gp, group),
                                     xn if group.pair else xn[None], cfg, pc)
        if emit_cache:
            if group.pair:  # already stacked [2, ...]
                cache["conv"], cache["h"] = conv, h
            else:
                cache["conv0"], cache["h0"] = conv[0], h[0]
    else:
        raise _not_ported(f"mixer {mixer!r}")
    x = x + pc.phase_out(out).to(x.dtype)

    # ---- phase 2: FFN ---------------------------------------------------
    aux = 0.0
    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", pc.phase_in(x), cfg, group)
        out, aux = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.phase_out(out).to(x.dtype)
    return x, aux, cache


def _mamba_params(gp, group: Group):
    """The group's Mamba weights with the leading path axis P (a single
    layer gets P = 1 as views)."""
    return gp["mamba"] if group.pair else tree_map(lambda w: w[None], gp["mamba"])


# ---------------------------------------------------------------------------
# Single-token decode group application
# ---------------------------------------------------------------------------

def apply_group_decode(gp, x, cache, t, *, cfg, group: Group, dims,
                       pc: ParallelContext, cache_layout="ring",
                       block_tables=None):
    """One group for one new token. x: [B,1,D]; ``cache`` entries are
    updated in place. Returns (x, cache).

    A pair takes the fused path: one decode_attn_standard(pair=True) call
    over the stacked [2, ...] cache (one QKV projection, one cache write,
    one attention launch, one phase_out per phase).

    cache_layout="paged" (continuous batching): ``t`` is an int32 [B]
    tensor of per-slot positions and the k/v entries are page pools
    indirected through ``block_tables`` [B, n_pg]; the pair stays one
    decode_attn_paged(pair=True) call.

    A Mamba group advances its state (``conv``/``h``, batch-indexed in both
    layouts: the pool keeps it per decode slot) by one token, for both
    halves of a pair in one ``ssm_mix`` call, and writes it back in
    place."""
    mixer = _homogeneous_kind(group)
    xn = _norm_inputs(gp, "ln1", x, cfg, group)
    if mixer == "mamba":
        names = ("conv", "h") if group.pair else ("conv0", "h0")
        conv, h = cache[names[0]], cache[names[1]]
        if not group.pair:
            conv, h = conv[None], h[None]
        out, (nconv, nh) = SSM.ssm_mix(_mamba_params(gp, group),
                                       xn if group.pair else xn[None], cfg,
                                       pc, state=(conv, h))
        conv.copy_(nconv)
        h.copy_(nh)
    elif mixer.startswith("attn"):
        names = ("k", "v") if group.pair else ("k0", "v0")
        if cache_layout == "paged":
            out, _, _ = A.decode_attn_paged(
                gp["attn"], xn, cache[names[0]], cache[names[1]], t,
                block_tables, cfg, dims, kind=mixer, pair=group.pair)
        else:
            out, _, _ = A.decode_attn_standard(
                gp["attn"], xn, cache[names[0]], cache[names[1]], t, cfg,
                dims, kind=mixer, pair=group.pair, window=cfg.window,
                chunk=cfg.chunk)
    else:
        raise _not_ported(f"mixer {mixer!r}")
    x = x + pc.psum_tp(out).to(x.dtype)

    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", x, cfg, group)
        out, _ = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.psum_tp(out).to(x.dtype)
    return x, cache
