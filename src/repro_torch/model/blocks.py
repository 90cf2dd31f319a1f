"""Layer and LP-pair application (attention + MLP groups, recurrent groups).

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

A recurrent group runs its mixer phase with the pair's paths on one
leading axis: Mamba (falcon-mamba: one mixer per layer, no FFN) through
``ssm.ssm_mix``, RG-LRU (recurrentgemma: with an MLP) through
``rglru.rglru_mix``. Its decode state is the conv window ``conv`` [B, K-1,
C] in the cache type and the recurrent state ``h`` in fp32 ([B, d_inner,
N] for Mamba, [B, lru_width, 1] for RG-LRU), stacked on the pair axis
under bare names like k/v (``conv0``/``h0`` for a single layer), and
updated in place.

An LP pair of two attention kinds (llama4's chunked + global layers:
different rings, and the global half takes no rotary embedding) keeps
per-layer cache entries ``k0``/``v0``/``k1``/``v1`` and runs its halves
one after the other: per-half attention cores in prefill (one merged output
projection, one phase_out) and one ring decode launch per half. The paged
pool refuses such a pair, as the JAX package does.

A layer with cross-attention (whisper's decoder) runs a third phase
between the mixer and the FFN: q from the normed stream (``lnx``), keys
and values projected from the encoder output once at prefill, never
roped, the mask bidirectional. Prefill writes them to the cache entries
``xk``/``xv`` ([2, B, T_enc, Hkv, hd] for a pair, ``xk0``/``xv0`` for a
single layer); decode only reads them. A pair's cross phase is one q
projection, one attention core with the pair folded into the batch axis
(the stacked cache is then a view, no copy) and one merged output
projection.

Ported: attention mixers (pairs of mixed attention kinds too, a
prefix-LM mask, cross-attention), Mamba mixers and RG-LRU mixers, with an
MLP, a mixture of experts (``moe.moe_forward``) or no FFN. Recurrent pairs
of mixed kinds raise ``NotImplementedError``.

At tp > 1 (every family) each rank runs its q heads and its stored kv
heads, on every attention kind: causal (with a prefix-LM's prefix too), the
window ring (``attn_local``), the chunk ring (``attn_chunked``), a pair of
mixed kinds (llama4's chunked + global), through ``_mixed_attention_full``
and the half-by-half decode, the encoder's bidirectional layers and the
cross-attention phase, whose ``xk``/``xv`` cache holds the rank's stored kv
heads. The core reads the rank's selection of the stored kv heads
(``_sel_pairwise``, ``_fold_ctx_kv``); replicated kv (fewer kv heads than
ranks: recurrentgemma's and paligemma's one) is stored whole on every
rank. The rank runs its d_ff columns of an MLP, its experts and its shard
of the shared expert of a mixture of experts (``moe``), its d_inner/tp
channels of a Mamba mixer and its lru_width/tp channels of an RG-LRU
mixer, whose ``conv``/``h`` state is the rank's channels
(``group_cache_meta``). Every phase ends in one ``psum_tp``, an LP pair's
phase of two layers too; a Mamba phase adds its x_proj's one stacked
``psum_tp``.

The sequence-sharded kv cache (``kv_mode="seq"``, ring layout only): a
full-length causal ring of replicated kv heads (``seq_sharded_kind``) is
cut along the sequence, ``L / tp`` positions a rank, instead of stored
whole on every rank; its decode is ``attention.decode_attn_seq_sharded``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig, LayerSpec
from repro_torch.model import attention as A
from repro_torch.model import mlp as M
from repro_torch.model import moe as MOE
from repro_torch.model import rglru as RG
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
                               "attention, Mamba and RG-LRU mixers, with "
                               "cross-attention, an MLP, a mixture of "
                               "experts or no FFN)")


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
    t: Dict[str, Any] = {"ln1": _norm_tmpl(cfg)}
    if spec.mixer.startswith("attn"):
        t["attn"] = A.attn_template(cfg, tp)
    elif spec.mixer == "mamba":
        t["mamba"] = SSM.ssm_template(cfg, tp)
    elif spec.mixer == "rec":
        t["rec"] = RG.rglru_template(cfg, tp)
    else:
        raise _not_ported(f"mixer {spec.mixer!r}")
    if spec.cross_attn:
        t["lnx"] = _norm_tmpl(cfg)
        # Cross-attention (q from the decoder stream, k and v from the
        # encoder output) has the self-attention layout.
        t["xattn"] = A.attn_template(cfg, tp)
    if spec.ffn == "mlp":
        t["ln2"] = _norm_tmpl(cfg)
        t["mlp"] = M.mlp_template(cfg, tp)
    elif spec.ffn == "moe":
        t["ln2"] = _norm_tmpl(cfg)
        t["moe"] = MOE.moe_template(cfg, tp)
    elif spec.ffn is not None:
        raise _not_ported(f"ffn {spec.ffn!r}")
    return t


# ---------------------------------------------------------------------------
# Phase runners
# ---------------------------------------------------------------------------

def _norm_inputs(gp, key, x, cfg, group: Group, differentiable=False):
    """Per-path normalised inputs: [B,S,D] (single) or [2,B,S,D] (pair)."""
    if group.pair:
        return dual_norm(x, tree_map(lambda v: v[0], gp[key]),
                         tree_map(lambda v: v[1], gp[key]), cfg,
                         differentiable=differentiable)
    return apply_norm(x, gp[key], cfg)


def _mixer_kinds(group: Group):
    return tuple(s.mixer for s in group.specs)


def pair_cache_stacked(group: Group) -> bool:
    """True when the group's decode caches use the stacked pair layout
    ([2, ...], bare key names) and the fused pair decode path. A pair of
    mixed attention kinds (llama4 chunked + global) keeps per-layer entries:
    its ring lengths and slots differ."""
    return group.pair and len(set(_mixer_kinds(group))) == 1


def _mixer(group: Group) -> str:
    """The group's mixer family: "attn" for any attention kinds (a pair
    may mix them), else its one recurrent kind (a recurrent pair of two
    kinds is not ported)."""
    kinds = set(_mixer_kinds(group))
    if all(k.startswith("attn") for k in kinds):
        return "attn"
    if len(kinds) != 1:
        raise _not_ported(f"a pair of mixed mixer kinds {sorted(kinds)}")
    return kinds.pop()


def attention_phase_full(gp, xn, cfg, dims, *, group: Group, positions,
                         prefix_len=0, cross_kv=None, attn_impl="auto",
                         ctx_kv=None, q0=0, differentiable=False,
                         pc: ParallelContext = ParallelContext()):
    """Full-sequence attention (prefill). Returns (partial_out, kv_list)
    with one (k, v) in stored layout per layer in the group.

    ``prefix_len`` (paligemma's prefix-LM): keys below it are visible to
    every query of a causal kind.

    ``cross_kv`` (whisper's decoder): the encoder output's k/v, projected
    by the caller in the folded layout [B,T,P*hkv,hd]; q comes from
    ``xn`` through the layer's ``xattn`` weights, and the mask is
    bidirectional (kind ``attn_bidir``, keys never roped).

    ``ctx_kv`` (suffix prefill, prefix sharing): this group's cached
    CONTEXT keys/values for absolute positions [0, q0), in stored layout
    ({"k"/"v"}: [2,B,Tc,hkv,hd] stacked pair, {"k0"/"v0"}: [B,Tc,hkv,hd]
    single layer; keys already roped). They are put before the suffix's
    fresh kv, so every suffix row reduces over exactly ``q0 + S`` keys: the
    reduction shape the full-prompt forward gives that row. ``q0`` is the
    absolute position of the first query row: an int, or a [B] tensor of
    per-row context lengths (bucketed radix-hit rows).

    ``differentiable`` (the train step's forward) goes to the attention
    core: a torch core on any device in place of the flash kernel.

    ``pc`` (tp > 1): the projections give the rank's q heads and its
    stored kv heads; the core reads the rank's selection of the kv heads
    (``_sel_pairwise``), in ``attention.core_layout``'s (Hk, g)."""
    kinds = _mixer_kinds(group)
    cross = cross_kv is not None
    p = gp["xattn"] if cross else gp["attn"]
    B = xn.shape[1] if group.pair else xn.shape[0]
    S = xn.shape[2] if group.pair else xn.shape[1]
    nP = 2 if group.pair else 1
    if len(set(kinds)) > 1 and not cross:
        return _mixed_attention_full(p, xn, cfg, dims, pc, kinds=kinds,
                                     positions=positions, prefix_len=prefix_len,
                                     attn_impl=attn_impl, ctx_kv=ctx_kv,
                                     differentiable=differentiable)
    kind = "attn_bidir" if cross else kinds[0]
    q = A.project_q(p, xn, cfg, dims, positions=positions, kind=kind,
                    pair=group.pair)
    if cross:
        k, v = cross_kv
    else:
        k, v = A.project_kv(p, xn, cfg, dims, positions=positions, kind=kind,
                            pair=group.pair)
    Hk, g = A.core_layout(dims)
    ks, vs = _sel_pairwise(k, v, dims, pc, pair=group.pair)
    if ctx_kv is not None:
        cks, cvs = _fold_ctx_kv(ctx_kv, dims, pc, group=group)
        ks = torch.cat([cks.to(ks.dtype), ks], dim=1)
        vs = torch.cat([cvs.to(vs.dtype), vs], dim=1)
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
    # Pair-major folds: q heads [2*hq] group onto kv heads [2*Hk].
    qh = q.reshape(B, S, nP * Hk, g, dims.hd)
    o = A.attention_core(qh, ks, vs, kind=kind, window=cfg.window,
                         chunk=cfg.chunk, prefix_len=prefix_len, q0=q0,
                         impl=attn_impl, differentiable=differentiable)
    o = o.reshape(B, S, nP * dims.hq, dims.hd)
    out = A.output_proj(p, o, dims, pair=group.pair)
    return out, _split_kv(k, v, dims, pair=group.pair)


def _mixed_attention_full(p, xn, cfg, dims, pc, *, kinds, positions,
                          prefix_len, attn_impl, ctx_kv, differentiable):
    """A pair of mixed attention kinds (llama4 chunked + global): per-half
    projections and cores, still one merged output projection and one
    phase_out. Returns (partial_out, [(k, v)] per half)."""
    if ctx_kv is not None:
        raise NotImplementedError(
            "suffix prefill supports homogeneous attention groups only")
    B, S = xn.shape[1], xn.shape[2]
    Hk, g = A.core_layout(dims)
    os, kvs = [], []
    for i, kind in enumerate(kinds):
        ph = tree_map(lambda w: w[i], p)
        qi = A.project_q(ph, xn[i], cfg, dims, positions=positions, kind=kind,
                         pair=False)
        ki, vi = A.project_kv(ph, xn[i], cfg, dims, positions=positions,
                              kind=kind, pair=False)
        ksi, vsi = _sel_pairwise(ki, vi, dims, pc, pair=False)
        oi = A.attention_core(qi.reshape(B, S, Hk, g, dims.hd),
                              ksi, vsi, kind=kind, window=cfg.window,
                              chunk=cfg.chunk, prefix_len=prefix_len,
                              impl=attn_impl, differentiable=differentiable)
        os.append(oi.reshape(B, S, dims.hq, dims.hd))
        kvs.append((ki, vi))
    o = torch.cat(os, dim=2)
    return A.output_proj(p, o, dims, pair=True), kvs


def _sel_pairwise(k, v, dims, pc, *, pair: bool):
    """The rank's kv heads of fresh projections (``A.select_local_kv``),
    keeping a pair's halves folded pair-major into the head axis."""
    if not pair:
        return A.select_local_kv(k, dims, pc), A.select_local_kv(v, dims, pc)
    if dims.kv_sharded or dims.tp == 1:
        return k, v
    B, S = k.shape[0], k.shape[1]
    k2 = A.select_local_kv(k.reshape(B, S, 2, dims.hkv, dims.hd), dims, pc,
                           head_axis=3)
    v2 = A.select_local_kv(v.reshape(B, S, 2, dims.hkv, dims.hd), dims, pc,
                           head_axis=3)
    return (k2.reshape(B, S, 2 * k2.shape[3], dims.hd),
            v2.reshape(B, S, 2 * v2.shape[3], dims.hd))


def _fold_ctx_kv(ctx_kv, dims, pc, *, group: Group):
    """Cached context kv (stored layout) -> the folded [B,Tc,P*Hk,hd]
    layout ``_sel_pairwise`` gives fresh projections, so a suffix forward
    can put context before suffix keys along the length axis. The pair
    fold is pair-major, as ``project_kv``'s.

    At tp > 1 a split-kv pool hands each rank its own heads, so the fold
    is pure layout; a replicated pool hands every rank all stored heads,
    and the rank selects its own here (the selection the paged decode
    kernel makes through its head map). Either way the folded head count
    must be ``core_layout``'s: a ctx tree of another layout raises rather
    than reduce at another shape than the cold full-prompt forward."""
    Hk, _ = A.core_layout(dims)
    if group.pair:
        ks = A.select_local_kv_pair(ctx_kv["k"], dims, pc)   # [2,B,Tc,Hk,hd]
        vs = A.select_local_kv_pair(ctx_kv["v"], dims, pc)
        if ks.shape[3] != Hk:
            raise ValueError(f"ctx kv folds to {ks.shape[3]} heads per pair "
                             f"half but the attention core reduces over {Hk}: "
                             "the ctx tree does not match this rank's kv layout")
        B, Tc = ks.shape[1], ks.shape[2]
        return (ks.movedim(0, 2).reshape(B, Tc, 2 * Hk, dims.hd),
                vs.movedim(0, 2).reshape(B, Tc, 2 * Hk, dims.hd))
    ks = A.select_local_kv(ctx_kv["k0"], dims, pc)           # [B,Tc,Hk,hd]
    vs = A.select_local_kv(ctx_kv["v0"], dims, pc)
    if ks.shape[2] != Hk:
        raise ValueError(f"ctx kv folds to {ks.shape[2]} heads but the "
                         f"attention core reduces over {Hk}: the ctx tree "
                         "does not match this rank's kv layout")
    return ks, vs


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
    if ffn == "mlp":
        return M.mlp_forward(gp["mlp"], xn, cfg, pc.tp_size, pair=group.pair), 0.0
    if ffn == "moe":
        return MOE.moe_forward(gp["moe"], xn, cfg, pc, pair=group.pair)
    raise _not_ported(f"ffn {ffn!r}")


# ---------------------------------------------------------------------------
# KV-cache construction
# ---------------------------------------------------------------------------

def ring_len(cfg, mixer: str, max_len: int) -> int:
    if mixer == "attn_local" and cfg.window:
        return min(cfg.window, max_len)
    if mixer == "attn_chunked" and cfg.chunk:
        return min(cfg.chunk, max_len)
    return max_len


def seq_sharded_kind(cfg, dims, mixer: str, kv_mode: str) -> bool:
    """Does ``kv_mode`` cut this mixer's ring along the sequence over the
    ranks? Only the full-length causal rings of replicated kv heads (fewer
    kv heads than ranks), as in the JAX package."""
    if kv_mode not in ("heads", "seq"):
        raise ValueError(f"kv_mode must be 'heads' or 'seq', got {kv_mode!r}")
    return (kv_mode == "seq" and mixer in ("attn", "attn_global")
            and not dims.kv_sharded and dims.tp > 1)


def _seq_shard_len(L: int, tp: int) -> int:
    """The positions of a ring of ``L`` that each of ``tp`` ranks holds."""
    if L % tp:
        raise ValueError(f"a sequence-sharded ring of {L} positions does not "
                         f"divide over tp={tp} ranks: choose max_len a "
                         "multiple of tp")
    return L // tp


def fill_cache(k, L: int, *, mixer, cfg, seq_shard=False,
               pc: ParallelContext = ParallelContext()):
    """Place prefill keys/values [B,S,hkv,hd] into a decode ring cache;
    with ``seq_shard`` the rank's ``L / tp`` positions of it (a copy)."""
    B, S, H, hd = k.shape
    if mixer == "attn_local" and cfg.window and S >= (W := ring_len(cfg, mixer, L)):
        return torch.roll(k[:, S - W:], (S - W) % W, dims=1)
    if mixer == "attn_chunked" and cfg.chunk:
        # The ring holds the chunk that position S falls in (empty when S
        # starts a chunk). The chunk's start is counted in whole chunks, not
        # in ring slots: a ring cut to L < chunk holds positions 0..L-1 of
        # the first chunk. (The JAX package counts in ring slots, so there a
        # prompt of exactly L tokens leaves an empty ring: ROADMAP §3.)
        C = ring_len(cfg, mixer, L)
        cstart = (S // cfg.chunk) * cfg.chunk
        ring = torch.zeros((B, C, H, hd), dtype=k.dtype, device=k.device)
        ring[:, :S - cstart] = k[:, cstart:]
        return ring
    Ls = ring_len(cfg, mixer, L)
    kp = torch.zeros((B, Ls, H, hd), dtype=k.dtype, device=k.device)
    n = min(S, Ls)
    kp[:, :n] = k[:, :n]
    if seq_shard:
        L_loc = _seq_shard_len(Ls, pc.tp_size)
        return kp[:, pc.tp_index() * L_loc:(pc.tp_index() + 1) * L_loc].clone()
    return kp


def group_cache_meta(cfg, group: Group, dims, *, batch: int, max_len: int,
                     kv_mode: str = "heads", enc_len: int = 0,
                     dtype=torch.bfloat16):
    """{entry name: (shape, dtype)} for one group's decode cache. A pair
    of one mixer kind stores one stacked entry per tensor under a bare name
    ("k", "v"; "xk", "xv"; "conv", "h") with a leading pair axis of 2; a
    single layer keeps indexed names ("k0", "v0"; "conv0", "h0"), and a
    pair of mixed attention kinds one indexed entry per layer ("k0", "v0",
    "k1", "v1"), each with its own ring length. Cross-attention layers add
    the encoder's keys and values ``xk``/``xv`` of length ``enc_len``. The
    recurrent state ``h`` (Mamba, RG-LRU) is fp32 whatever the cache
    type. Every width is this rank's (``dims.tp``): its stored kv heads,
    and d_inner/tp (Mamba) or lru_width/tp (RG-LRU) state channels; a ring
    that ``kv_mode`` cuts along the sequence (``seq_sharded_kind``) holds
    the rank's ring_len / tp positions."""
    cross = (batch, enc_len, dims.hkv, dims.hd)

    def ring(mixer):
        L = ring_len(cfg, mixer, max_len)
        if seq_sharded_kind(cfg, dims, mixer, kv_mode):
            L = _seq_shard_len(L, dims.tp)
        return (batch, L, dims.hkv, dims.hd)

    if _mixer(group) == "attn" and group.pair and not pair_cache_stacked(group):
        out = {}
        for i, spec in enumerate(group.specs):
            shp = ring(spec.mixer)
            out[f"k{i}"], out[f"v{i}"] = (shp, dtype), (shp, dtype)
            if spec.cross_attn:
                out[f"xk{i}"], out[f"xv{i}"] = (cross, dtype), (cross, dtype)
        return out
    mixer = group.specs[0].mixer
    if mixer.startswith("attn"):
        shp = ring(mixer)
        entries = {"k": (shp, dtype), "v": (shp, dtype)}
        if group.specs[0].cross_attn:
            entries.update(xk=(cross, dtype), xv=(cross, dtype))
    elif mixer == "mamba":
        di = cfg.d_inner // dims.tp
        entries = {"conv": ((batch, cfg.ssm_conv - 1, di), dtype),
                   "h": ((batch, di, cfg.ssm_state), torch.float32)}
    elif mixer == "rec":
        W = cfg.lru_width // dims.tp
        entries = {"conv": ((batch, cfg.rec_conv - 1, W), dtype),
                   "h": ((batch, W, 1), torch.float32)}
    else:
        raise _not_ported(f"mixer {mixer!r}")
    if group.pair:
        return {name: ((2, *shp), dt) for name, (shp, dt) in entries.items()}
    return {f"{name}0": spec for name, spec in entries.items()}


#: Recurrent mixers: the mixer kind is also its weights' key in the layer.
_RECURRENT = {"mamba": SSM.ssm_mix, "rec": RG.rglru_mix}


def _recurrent_params(gp, group: Group, mixer: str):
    """The group's recurrent-mixer weights with the leading path axis P (a
    single layer gets P = 1 as views)."""
    return gp[mixer] if group.pair else tree_map(lambda w: w[None], gp[mixer])


# ---------------------------------------------------------------------------
# Full-sequence group application (prefill)
# ---------------------------------------------------------------------------

def apply_group_full(gp, x, *, cfg, group: Group, dims, pc: ParallelContext,
                     positions, prefix_len=0, enc_out=None, attn_impl="auto",
                     emit_cache=False, max_len=0, kv_mode="heads", ctx_kv=None,
                     q0=0, differentiable=False):
    """One group over the full sequence. x: [B,S,D]. Returns (x, aux,
    cache_dict).

    ``prefix_len``: the prefix-LM's bidirectional prefix (causal kinds).
    ``enc_out`` [B,T,D]: the encoder output, which layers with
    cross-attention attend to in a phase between the mixer and the FFN.
    ``kv_mode``: the emitted ring caches' layout (``seq_sharded_kind``).

    ``ctx_kv``/``q0`` (suffix prefill): cached kv for positions [0, q0) in
    stored layout; the sequence starts at absolute position ``q0``. The
    emitted cache covers only the suffix (length ``max_len``, local 0 ==
    absolute ``q0``); the caller places it after the context.

    ``differentiable`` (set by the train step only): the four kernel sites
    (the attention core, the pair's dual RMSNorm, the Mamba and RG-LRU
    scans) run their torch versions on any device, so autograd sees the
    whole forward; the kernels have no backward."""
    cache: Dict[str, Any] = {}
    mixer = _mixer(group)
    diff = differentiable

    # ---- phase 1: the mixer ---------------------------------------------
    xn = _norm_inputs(gp, "ln1", pc.phase_in(x), cfg, group, diff)
    if mixer == "attn":
        out, kvs = attention_phase_full(gp, xn, cfg, dims, group=group,
                                        positions=positions,
                                        prefix_len=prefix_len,
                                        attn_impl=attn_impl, ctx_kv=ctx_kv,
                                        q0=q0, differentiable=diff, pc=pc)
        if emit_cache:
            fks, fvs = [], []
            for (k, v), m in zip(kvs, _mixer_kinds(group)):
                ss = seq_sharded_kind(cfg, dims, m, kv_mode)
                fks.append(fill_cache(k, max_len, mixer=m, cfg=cfg,
                                      seq_shard=ss, pc=pc))
                fvs.append(fill_cache(v, max_len, mixer=m, cfg=cfg,
                                      seq_shard=ss, pc=pc))
            if pair_cache_stacked(group):  # stacked layout for the fused decode
                cache["k"], cache["v"] = torch.stack(fks), torch.stack(fvs)
            else:
                for i, (fk, fv) in enumerate(zip(fks, fvs)):
                    cache[f"k{i}"], cache[f"v{i}"] = fk, fv
    elif mixer in _RECURRENT:
        if ctx_kv is not None:
            raise NotImplementedError(
                "suffix prefill needs attention mixers (recurrent state "
                "cannot resume from cached kv)")
        out, (conv, h) = _RECURRENT[mixer](_recurrent_params(gp, group, mixer),
                                           xn if group.pair else xn[None],
                                           cfg, pc, differentiable=diff)
        if emit_cache:
            if group.pair:  # already stacked [2, ...]
                cache["conv"], cache["h"] = conv, h
            else:
                cache["conv0"], cache["h0"] = conv[0], h[0]
    else:
        raise _not_ported(f"mixer {mixer!r}")
    x = x + pc.phase_out(out).to(x.dtype)

    # ---- cross-attention phase (whisper's decoder) ----------------------
    if group.specs[0].cross_attn and enc_out is not None:
        xnx = _norm_inputs(gp, "lnx", pc.phase_in(x), cfg, group, diff)
        enc_in = torch.stack([enc_out] * 2) if group.pair else enc_out
        xk, xv = A.project_kv(gp["xattn"], enc_in, cfg, dims, positions=None,
                              kind="attn_bidir", pair=group.pair)
        out, halves = attention_phase_full(gp, xnx, cfg, dims, group=group,
                                           positions=positions,
                                           cross_kv=(xk, xv),
                                           attn_impl=attn_impl,
                                           differentiable=diff)
        if emit_cache:
            if pair_cache_stacked(group):
                cache["xk"] = torch.stack([k for k, _ in halves])
                cache["xv"] = torch.stack([v for _, v in halves])
            else:
                for i, (k, v) in enumerate(halves):
                    cache[f"xk{i}"], cache[f"xv{i}"] = k, v
        x = x + pc.phase_out(out).to(x.dtype)

    # ---- phase 2: FFN ---------------------------------------------------
    aux = 0.0
    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", pc.phase_in(x), cfg, group, diff)
        out, aux = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.phase_out(out).to(x.dtype)
    return x, aux, cache


# ---------------------------------------------------------------------------
# Single-token decode group application
# ---------------------------------------------------------------------------

def apply_group_decode(gp, x, cache, t, *, cfg, group: Group, dims,
                       pc: ParallelContext, kv_mode="heads",
                       cache_layout="ring", block_tables=None):
    """One group for one new token. x: [B,1,D]; ``cache`` entries are
    updated in place. Returns (x, cache).

    A pair of one attention kind takes the fused path: one
    decode_attn_standard(pair=True) call over the stacked [2, ...] cache
    (one QKV projection, one cache write, one attention launch, one
    phase_out per phase). A pair of mixed attention kinds decodes half by
    half over its per-layer rings (one launch each), still one phase_out;
    the paged pool refuses it.

    cache_layout="paged" (continuous batching): ``t`` is an int32 [B]
    tensor of per-slot positions and the k/v entries are page pools
    indirected through ``block_tables`` [B, n_pg]; the pair stays one
    decode_attn_paged(pair=True) call.

    A recurrent group (Mamba, RG-LRU) advances its state (``conv``/``h``,
    batch-indexed in both layouts: the pool keeps it per decode slot) by
    one token, for both halves of a pair in one mixer call, and writes it
    back in place.

    A layer with cross-attention then attends to the encoder's keys and
    values that prefill left in ``xk``/``xv`` (read, never written).

    ``kv_mode="seq"`` (ring layout only): a ring that prefill cut along the
    sequence (``seq_sharded_kind``) decodes through
    ``attention.decode_attn_seq_sharded``, a pair as one call; a paged
    call raises, since pages shard kv heads, not the sequence."""
    mixer = _mixer(group)
    paged = cache_layout == "paged"
    if paged and kv_mode != "heads":
        raise NotImplementedError(
            f"paged decode supports kv_mode='heads' only (got {kv_mode!r}): "
            "pages shard kv heads over the ranks, not the sequence")
    if paged and group.pair and not pair_cache_stacked(group):
        raise NotImplementedError(
            "paged decode requires the stacked pair cache layout "
            "(heterogeneous attention pairs are not pageable)")
    xn = _norm_inputs(gp, "ln1", x, cfg, group)
    if mixer in _RECURRENT:
        names = ("conv", "h") if group.pair else ("conv0", "h0")
        conv, h = cache[names[0]], cache[names[1]]
        if not group.pair:
            conv, h = conv[None], h[None]
        out, (nconv, nh) = _RECURRENT[mixer](_recurrent_params(gp, group, mixer),
                                             xn if group.pair else xn[None],
                                             cfg, pc, state=(conv, h))
        conv.copy_(nconv)
        h.copy_(nh)
    elif group.pair and not pair_cache_stacked(group):
        # A pair of mixed attention kinds: half by half over its own rings.
        outs = []
        for i, kind in enumerate(_mixer_kinds(group)):
            decode = (A.decode_attn_seq_sharded
                      if seq_sharded_kind(cfg, dims, kind, kv_mode)
                      else A.decode_attn_standard)
            o, _, _ = decode(
                tree_map(lambda w: w[i], gp["attn"]), xn[i], cache[f"k{i}"],
                cache[f"v{i}"], t, cfg, dims, kind=kind, pair=False,
                window=cfg.window, chunk=cfg.chunk, pc=pc)
            outs.append(o)
        out = outs[0] + outs[1]
    else:
        kind = group.specs[0].mixer
        names = ("k", "v") if group.pair else ("k0", "v0")
        if paged:
            out, _, _ = A.decode_attn_paged(
                gp["attn"], xn, cache[names[0]], cache[names[1]], t,
                block_tables, cfg, dims, kind=kind, pair=group.pair, pc=pc)
        else:
            decode = (A.decode_attn_seq_sharded
                      if seq_sharded_kind(cfg, dims, kind, kv_mode)
                      else A.decode_attn_standard)
            out, _, _ = decode(
                gp["attn"], xn, cache[names[0]], cache[names[1]], t, cfg,
                dims, kind=kind, pair=group.pair, window=cfg.window,
                chunk=cfg.chunk, pc=pc)
    x = x + pc.psum_tp(out).to(x.dtype)

    if group.specs[0].cross_attn:
        xnx = _norm_inputs(gp, "lnx", x, cfg, group)
        out = _cross_attention_decode(gp["xattn"], xnx, cache, cfg, dims,
                                      group=group, pc=pc)
        x = x + pc.psum_tp(out).to(x.dtype)

    if group.specs[0].ffn is not None:
        xn2 = _norm_inputs(gp, "ln2", x, cfg, group)
        out, _ = ffn_phase(gp, xn2, cfg, pc, group=group)
        x = x + pc.psum_tp(out).to(x.dtype)
    return x, cache


def _cross_attention_decode(p, xnx, cache, cfg, dims, *, group: Group,
                            pc: ParallelContext):
    """One token's cross-attention over the encoder kv of the cache
    (``xk``/``xv``, never written here). Returns the partial output
    [B,1,D]. The core is the dense impl, as in the JAX package; on a CUDA
    tensor it is the flash kernel with the bidirectional mask.

    A stacked pair is one q projection, one core and one merged output
    projection: the pair goes into the core's batch axis, where the
    stacked cache [2, B, T, Hkv, hd] is a view as [2B, T, Hkv, hd] (folded
    into the head axis it would need a copy of the whole cache every
    step). A single layer, or each half of a pair of mixed kinds, runs one
    projection, core and output projection of its own.

    At tp > 1 the cache holds the rank's stored kv heads, and the core
    reads the rank's selection of them (``select_local_kv``), in
    ``core_layout``'s (Hk, g)."""
    hkv, g = A.core_layout(dims)
    hd = dims.hd
    if pair_cache_stacked(group):
        xk = A.select_local_kv_pair(cache["xk"], dims, pc)   # [2,B,T,Hk,hd]
        xv = A.select_local_kv_pair(cache["xv"], dims, pc)
        B, T = xk.shape[1], xk.shape[2]
        q = A.project_q(p, xnx, cfg, dims, positions=None, kind="attn_bidir",
                        pair=True)                          # [B,1,2*hq,hd]
        qb = q.reshape(B, 1, 2, hkv, g, hd).permute(2, 0, 1, 3, 4, 5)
        o = A.attention_core(A._widen(qb.reshape(2 * B, 1, hkv, g, hd), xk),
                             xk.reshape(2 * B, T, hkv, hd),
                             xv.reshape(2 * B, T, hkv, hd),
                             kind="attn_bidir", impl="dense").to(xnx.dtype)
        o = o.reshape(2, B, 1, dims.hq, hd).permute(1, 2, 0, 3, 4)
        return A.output_proj(p, o.reshape(B, 1, 2 * dims.hq, hd), dims,
                             pair=True)
    out = 0.0
    for i in range(len(group.specs)):
        ph = tree_map(lambda w: w[i], p) if group.pair else p
        xi = xnx[i] if group.pair else xnx
        q = A.project_q(ph, xi, cfg, dims, positions=None, kind="attn_bidir",
                        pair=False)
        B = q.shape[0]
        xk = A.select_local_kv(cache[f"xk{i}"], dims, pc)
        xv = A.select_local_kv(cache[f"xv{i}"], dims, pc)
        o = A.attention_core(A._widen(q.reshape(B, 1, hkv, g, hd), xk), xk,
                             xv, kind="attn_bidir", impl="dense").to(xnx.dtype)
        out = out + A.output_proj(ph, o.reshape(B, 1, dims.hq, hd), dims,
                                  pair=False)
    return out
