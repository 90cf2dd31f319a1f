"""Vocab-parallel embedding, LM head and greedy/sampled token choice.

Same functions and conventions as the JAX package (vocabulary padded to a
multiple of tp, logits over the LOCAL vocabulary shard, pad columns masked);
at world size 1 the shard is the whole vocabulary.
"""
from __future__ import annotations

import torch

from repro_torch.model.params import PD
from repro_torch.parallel.context import ParallelContext


def vocab_pad(V: int, tp: int) -> int:
    return -(-V // tp) * tp


def embed_template(cfg, tp: int):
    Vp = vocab_pad(cfg.vocab_size, tp)
    t = {"tok": PD((Vp, cfg.d_model), fan_in=cfg.d_model)}
    if cfg.pos_embed == "learned":
        t["pos"] = PD((cfg.max_position, cfg.d_model), fan_in=cfg.d_model)
    if not cfg.tie_embeddings:
        t["head"] = PD((cfg.d_model, Vp))
    return t


def embed_lookup(p, ids, pc: ParallelContext):
    """ids: [B,S] global token ids -> TP-partial [B,S,D]."""
    tok = p["tok"]
    v_local = tok.shape[0]
    base = pc.tp_index() * v_local
    lid = ids - base
    ok = (lid >= 0) & (lid < v_local)
    emb = tok[lid.clamp(0, v_local - 1)]
    return torch.where(ok[..., None], emb, torch.zeros((), dtype=tok.dtype,
                                                      device=tok.device))


def add_positions(p, x, positions):
    if "pos" not in p:
        return x
    return x + p["pos"][positions].to(x.dtype)


def local_logits(p, x, cfg, pc: ParallelContext):
    """x: [B,S,D] full -> local logits [B,S,V/tp] (fp32, pad masked)."""
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    logits = (x @ w.to(x.dtype)).float()
    v_local = logits.shape[-1]
    base = pc.tp_index() * v_local
    col = base + torch.arange(v_local, device=logits.device)
    logits = torch.where(col < cfg.vocab_size, logits, -1e30)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def vocab_parallel_argmax(logits, pc: ParallelContext):
    """Greedy next token from LOCAL logits [B,Vl] (deterministic tie-break:
    smallest global id among the maximisers)."""
    v_local = logits.shape[-1]
    base = pc.tp_index() * v_local
    val = logits.max(-1).values
    idx = base + logits.argmax(-1)
    gmax = pc.pmax_tp(val)
    cand = torch.where(val >= gmax, idx, torch.full_like(idx, 2**30))
    return -pc.pmax_tp(-cand)  # global min over candidates


def vocab_parallel_sample(logits, generator: torch.Generator, temperature,
                          pc: ParallelContext):
    """Gumbel-max sampling: independent Gumbel noise per column from
    ``generator`` (which must live on the logits' device), then the argmax
    is an exact sample from softmax(logits/T). The noise stream differs from
    JAX's threefry stream; compare sampled paths by distribution."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(u.clamp_min(tiny)))
    return vocab_parallel_argmax(logits / max(temperature, 1e-6) + g, pc)
