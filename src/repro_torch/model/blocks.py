"""Layer and LP-pair application (attention + MLP groups).

A ``Group`` is either one layer or an LP pair of two consecutive layers. The
pair path is the paper's Fig. 2b rewrite:

    a = x + A_k(LN1_k x) + A_{k+1}(LN1_{k+1} x)     # ONE phase_out
    y = a + F_k(LN2_k a) + F_{k+1}(LN2_{k+1} a)     # ONE phase_out

Pair params are the two layers' params stacked on a leading axis. A pair
whose halves share one mixer kind stores its decode caches stacked on a
leading pair axis — ``k``/``v``: [2, B, L, Hkv, hd] under bare names, while
single layers keep indexed names ``k0``/``v0`` — and decodes as ONE call
into ``attention.decode_attn_standard(pair=True)``. Decode updates the
caches in place.

Only attention mixers with an MLP are ported so far: mamba, RG-LRU, MoE,
cross-attention and pairs of mixed attention kinds raise
``NotImplementedError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.model import attention as A
from repro_torch.model import mlp as M
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
                               "attention + MLP layers)")


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
    if not spec.mixer.startswith("attn"):
        raise _not_ported(f"mixer {spec.mixer!r}")
    if spec.cross_attn:
        raise _not_ported("cross-attention")
    t: Dict[str, Any] = {"ln1": _norm_tmpl(cfg), "attn": A.attn_template(cfg, tp)}
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
        raise _not_ported(f"a pair of mixed attention kinds {sorted(kinds)}")
    return kinds.pop()


def attention_phase_full(gp, xn, cfg, dims, *, group: Group, positions,
                         attn_impl="auto"):
    """Full-sequence attention (prefill). Returns (partial_out, kv_list)
    with one (k, v) in stored layout per layer in the group."""
    kind = _homogeneous_kind(group)
    p = gp["attn"]
    B = xn.shape[1] if group.pair else xn.shape[0]
    S = xn.shape[2] if group.pair else xn.shape[1]
    nP = 2 if group.pair else 1
    q = A.project_q(p, xn, cfg, dims, positions=positions, kind=kind,
                    pair=group.pair)
    k, v = A.project_kv(p, xn, cfg, dims, positions=positions, kind=kind,
                        pair=group.pair)
    # Pair-major folds: q heads [2*hq] group onto kv heads [2*hkv].
    qh = q.reshape(B, S, nP * dims.hkv, dims.group, dims.hd)
    o = A.attention_core(qh, k, v, kind=kind, window=cfg.window,
                         chunk=cfg.chunk, impl=attn_impl)
    o = o.reshape(B, S, nP * dims.hq, dims.hd)
    out = A.output_proj(p, o, dims, pair=group.pair)
    return out, _split_kv(k, v, dims, pair=group.pair)


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
    stores one stacked entry per tensor under a bare name ("k", "v") with a
    leading pair axis of 2; a single layer keeps indexed names ("k0",
    "v0")."""
    mixer = _homogeneous_kind(group)
    if not mixer.startswith("attn"):
        raise _not_ported(f"mixer {mixer!r}")
    shp = (batch, ring_len(cfg, mixer, max_len), dims.hkv, dims.hd)
    if group.pair:
        return {"k": ((2, *shp), dtype), "v": ((2, *shp), dtype)}
    return {"k0": (shp, dtype), "v0": (shp, dtype)}


# ---------------------------------------------------------------------------
# Full-sequence group application (prefill)
# ---------------------------------------------------------------------------

def apply_group_full(gp, x, *, cfg, group: Group, dims, pc: ParallelContext,
                     positions, attn_impl="auto", emit_cache=False, max_len=0):
    """One group over the full sequence. x: [B,S,D]. Returns (x, aux,
    cache_dict)."""
    cache: Dict[str, Any] = {}
    mixer = _homogeneous_kind(group)
    if not mixer.startswith("attn"):
        raise _not_ported(f"mixer {mixer!r}")

    # ---- phase 1: attention ---------------------------------------------
    xn = _norm_inputs(gp, "ln1", pc.phase_in(x), cfg, group)
    out, kvs = attention_phase_full(gp, xn, cfg, dims, group=group,
                                    positions=positions, attn_impl=attn_impl)
    if emit_cache:
        fks = [fill_cache(k, max_len, mixer=mixer, cfg=cfg) for k, _ in kvs]
        fvs = [fill_cache(v, max_len, mixer=mixer, cfg=cfg) for _, v in kvs]
        if group.pair:  # stacked-contiguous pair layout for the fused decode
            cache["k"], cache["v"] = torch.stack(fks), torch.stack(fvs)
        else:
            cache["k0"], cache["v0"] = fks[0], fvs[0]
    x = x + pc.phase_out(out).to(x.dtype)

    # ---- phase 2: FFN ---------------------------------------------------
    aux = 0.0
    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", pc.phase_in(x), cfg, group)
        out, aux = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.phase_out(out).to(x.dtype)
    return x, aux, cache


# ---------------------------------------------------------------------------
# Single-token decode group application
# ---------------------------------------------------------------------------

def apply_group_decode(gp, x, cache, t: int, *, cfg, group: Group, dims,
                       pc: ParallelContext):
    """One group for one new token against its ring cache. x: [B,1,D];
    ``cache`` entries are updated in place. Returns (x, cache).

    A pair takes the fused path: one decode_attn_standard(pair=True) call
    over the stacked [2, ...] cache (one QKV projection, one cache write,
    one attention launch, one phase_out per phase)."""
    mixer = _homogeneous_kind(group)
    if not mixer.startswith("attn"):
        raise _not_ported(f"mixer {mixer!r}")

    xn = _norm_inputs(gp, "ln1", x, cfg, group)
    names = ("k", "v") if group.pair else ("k0", "v0")
    out, _, _ = A.decode_attn_standard(
        gp["attn"], xn, cache[names[0]], cache[names[1]], t, cfg, dims,
        kind=mixer, pair=group.pair, window=cfg.window, chunk=cfg.chunk)
    x = x + pc.psum_tp(out).to(x.dtype)

    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", x, cfg, group)
        out, _ = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.psum_tp(out).to(x.dtype)
    return x, cache
