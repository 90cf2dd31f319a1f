"""Per-(architecture x shape) cell policy + abstract input specs.

``cell_policy`` holds the static decisions the launcher makes per cell:
the LP plan, FSDP on or off, the KV-cache mode, the gradient-accumulation
factor, batch sharding, by the JAX package's rules at any tp and dp.
``batch_specs`` and ``decode_specs`` give the inputs one rank's step of a
cell runs on, as "meta" tensors of the rank's local shapes (no storage):
the counterpart of JAX's ``ShapeDtypeStruct`` with a ``NamedSharding``,
cut by its sharding. The dry run (``launch/dryrun.py``) runs rank 0 on
them.
"""
from __future__ import annotations

from dataclasses import dataclass

from typing import Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.lp import LPPlan, default_plan
from repro_torch.model import transformer as T

# Architectures whose bf16 weights per chip exceed a TPU v5e's HBM at TP=16
# and therefore train AND serve with FSDP (ZeRO-3) over the data axis, as
# the JAX package decides (the dry run keeps its policy).
FSDP_ARCHS = frozenset({"dbrx-132b", "llama4-scout-17b-a16e"})
# Architectures that fit for serving but whose train step (fp32 grads +
# optimizer + activations) needs the weights sharded too.
TRAIN_FSDP_ARCHS = FSDP_ARCHS | frozenset({"granite-34b"})


@dataclass(frozen=True)
class CellPolicy:
    plan: LPPlan
    fsdp: bool
    kv_mode: str          # heads | seq
    accum: int            # train-shape gradient accumulation
    shard_batch: bool     # False -> replicate batch over dp (e.g. batch 1)
    sp: bool              # sequence parallelism for full-seq programs
    remat: bool = True
    quant: bool = False   # int8 FSDP weight shards (serving only)


def cell_policy(cfg: ArchConfig, shape: ShapeConfig, *, tp: int = 1,
                dp: int = 1, lp: bool = True) -> CellPolicy:
    plan = default_plan(cfg) if lp else LPPlan(())
    fsdp = cfg.name in (FSDP_ARCHS if shape.step == "decode"
                        else TRAIN_FSDP_ARCHS)
    # Decode caches: sequence-shard over `model` when kv heads < tp
    # (avoids tp-fold cache replication).
    kv_mode = "seq" if (0 < cfg.n_kv_heads < tp) else "heads"
    shard_batch = shape.global_batch % dp == 0
    # Keep per-microbatch activations ~1 sequence per chip for train.
    local_batch = shape.global_batch // dp if shard_batch else shape.global_batch
    accum = max(1, local_batch) if shape.step == "train" else 1
    # Cap accum so the scan stays shallow on small-activation archs.
    if cfg.d_model * shape.seq_len <= 2048 * 4096:
        accum = max(1, local_batch // 4)
    return CellPolicy(plan=plan, fsdp=fsdp, kv_mode=kv_mode, accum=accum,
                      shard_batch=shard_batch, sp=True)


def build_cell_structure(cfg: ArchConfig, shape: ShapeConfig, pol: CellPolicy,
                         *, tp: int = 1, data: int = 1) -> T.ModelStructure:
    return T.build_structure(cfg, plan=pol.plan, tp=tp, fsdp=pol.fsdp,
                             fsdp_data=data, quant=pol.quant)


# ---------------------------------------------------------------------------
# Abstract inputs: one rank's local shapes, on meta
# ---------------------------------------------------------------------------

TOKEN_DTYPE = torch.int64      # the port's token ids
EMBED_DTYPE = torch.bfloat16   # prefix and frame embeddings


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def local_rows(shape: ShapeConfig, pol: CellPolicy, dp: int) -> int:
    """A rank's rows of the global batch: its block of ``dp`` where the
    policy shards the batch, else all of them (replicated)."""
    return shape.global_batch // dp if pol.shard_batch else shape.global_batch


def batch_specs(cfg: ArchConfig, shape: ShapeConfig, pol: CellPolicy, *,
                dp: int = 1) -> Dict[str, torch.Tensor]:
    """A train or prefill batch of one cell as one of ``dp`` data ranks
    holds it: tokens (and labels for train) [rows, S] and the prefix or
    frame embeddings [rows, P or T, D]."""
    B, S = local_rows(shape, pol, dp), shape.seq_len
    out = {"tokens": _meta((B, S), TOKEN_DTYPE)}
    if shape.step == "train":
        out["labels"] = _meta((B, S), TOKEN_DTYPE)
    if cfg.prefix_len:
        out["prefix"] = _meta((B, cfg.prefix_len, cfg.d_model), EMBED_DTYPE)
    if cfg.enc_layers:
        out["frames"] = _meta((B, cfg.enc_seq, cfg.d_model), EMBED_DTYPE)
    return out


def decode_specs(cfg: ArchConfig, shape: ShapeConfig, pol: CellPolicy,
                 ms: T.ModelStructure, *, dp: int = 1
                 ) -> Tuple[torch.Tensor, List[Dict[str, torch.Tensor]], int]:
    """(tok [rows], caches, t) of one decode step of a cell at one rank:
    the rank's rows (``local_rows``; the cache's batch axis is
    ``T.cache_batch_axis``'s) of the cache ``T.cache_meta`` gives the
    rank's tp shard of, by the policy's ``kv_mode``, and the position of
    the token, the cache's last."""
    B = local_rows(shape, pol, dp)
    meta = T.cache_meta(ms, batch=B, max_len=shape.seq_len, kv_mode=pol.kv_mode)
    caches = [{name: _meta(s, dt) for name, (s, dt) in seg.items()} for seg in meta]
    return _meta((B,), TOKEN_DTYPE), caches, shape.seq_len - 1
