"""Per-(architecture x shape) cell policy at tp = 1.

``cell_policy`` holds the static decisions the launcher makes per cell:
the LP plan, FSDP on or off, the KV-cache mode, the gradient-accumulation
factor, batch sharding. It is the JAX package's decision at one rank; the
abstract sharded inputs it lowers against need ranks (ROADMAP item 10.4).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.core.lp import LPPlan, default_plan

# Architectures whose bf16 weights per chip exceed a TPU v5e's HBM at TP=16
# and therefore train AND serve with FSDP (ZeRO-3) over the data axis in
# the JAX package: recorded as it decides, not applied at one rank.
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
    if tp != 1 or dp != 1:
        raise NotImplementedError(
            f"cell policy at tp={tp}, dp={dp}: tensor and data parallelism "
            "are not ported yet: ROADMAP item 10.4")
    plan = default_plan(cfg) if lp else LPPlan(())
    fsdp = cfg.name in (FSDP_ARCHS if shape.step == "decode"
                        else TRAIN_FSDP_ARCHS)
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
