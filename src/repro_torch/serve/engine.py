"""One-shot serving: batched prefill, then an autoregressive decode loop.

The programs of the JAX package's ``serve/engine.py`` (one-shot part):
  make_prefill     — logits + cache from a full prompt batch
  make_serve_step  — ONE new token against the cache
  generate         — prefill, then ``n_new - 1`` decode steps

The decode loop is a Python loop where the JAX package runs ``lax.scan``;
the KV cache is updated in place, so the loop holds one copy of it.
Sampling is greedy (argmax, smallest id on ties) or Gumbel-max from a
``torch.Generator``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from repro_torch.model import embedding as E
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree
from repro_torch.parallel.context import ParallelContext
from repro_torch.serve import bucketing as BK


@dataclass(frozen=True)
class ServeConfig:
    max_len: int = 1024           # KV-cache length
    temperature: float = 0.0      # 0 -> greedy
    cache_dtype: Any = torch.bfloat16
    # Pinned-tile prefill attention (serve.bucketing): every prefill
    # consumer runs the same impl.
    attn_impl: str = BK.PREFILL_ATTN_IMPL


def make_prefill(ms: T.ModelStructure, pc: ParallelContext, sv: ServeConfig):
    def prefill_fn(params, tokens):
        return T.prefill(params, tokens, ms=ms, pc=pc, max_len=sv.max_len,
                         attn_impl=sv.attn_impl, cache_dtype=sv.cache_dtype)
    return prefill_fn


def _choose(logits, generator, sv: ServeConfig, pc: ParallelContext):
    if sv.temperature > 0:
        return E.vocab_parallel_sample(logits, generator, sv.temperature, pc)
    return E.vocab_parallel_argmax(logits, pc)


def make_serve_step(ms: T.ModelStructure, pc: ParallelContext, sv: ServeConfig):
    """serve_step(params, tok [B], caches, t, generator) -> (next_tok [B],
    caches): embed -> stack -> head -> greedy or sampled choice. The caches
    are updated in place."""
    def serve_fn(params, tok, caches, t, generator=None):
        logits, caches = T.decode_step(params, tok, caches, t, ms=ms, pc=pc)
        return _choose(logits, generator, sv, pc), caches
    return serve_fn


def _now(dev: torch.device) -> float:
    """Host clock once the device has finished the work queued so far."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


@torch.no_grad()
def generate(params, prompts, n_new: int, *, ms: T.ModelStructure,
             pc: ParallelContext, sv: ServeConfig,
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None):
    """Greedy/temperature generation: returns [B, n_new] new tokens.

    ``prompts`` [B, S] must lie on the weights' device. Sampling
    (``sv.temperature > 0``) draws from ``generator``, which must live on
    that device too. A ``timings`` dict receives ``prefill_s`` (prefill and
    the first token's choice) and ``decode_s`` (the ``n_new - 1`` decode
    steps) of this call, in seconds; each mark waits for the device."""
    params = as_tree(params)
    dev = params["embed"]["tok"].device
    if prompts.device != dev:
        raise ValueError(f"prompts on {prompts.device}, weights on {dev}")
    t0 = prompts.shape[1]
    if t0 + n_new - 1 > sv.max_len:
        raise ValueError(f"prompt {t0} + {n_new} new tokens overflow the "
                         f"cache (max_len={sv.max_len})")
    if sv.temperature > 0 and generator is None:
        raise ValueError("sampling needs a torch.Generator")
    prefill_fn = make_prefill(ms, pc, sv)
    step_fn = make_serve_step(ms, pc, sv)
    marks = [_now(dev)] if timings is not None else None
    logits, caches = prefill_fn(params, prompts)
    tok = _choose(logits, generator, sv, pc)
    if marks:
        marks.append(_now(dev))
    toks = []
    for i in range(n_new - 1):
        # ``tok`` sits at absolute position t0 + i; its logits predict i+1.
        nxt, caches = step_fn(params, tok, caches, t0 + i, generator)
        toks.append(tok)
        tok = nxt
    if marks:
        marks.append(_now(dev))
        timings.update(prefill_s=marks[1] - marks[0], decode_s=marks[2] - marks[1])
    return torch.stack(toks + [tok], dim=1)
