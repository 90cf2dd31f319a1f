"""One-card dry run: the memory and roofline story of every (architecture x
input shape) cell on one NVIDIA H100, at tp = 1, without running a step.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-lp]

The JAX package's dry run lowers and compiles each cell over a TPU mesh and
reads XLA's ``cost_analysis`` and ``memory_analysis``. PyTorch has no
counterpart of either, so every number here is analytic
(``"cost_source": "analytic"``) and allocates nothing: the weights come from
``transformer.abstract_params`` (meta tensors), the decode cache from
``transformer.cache_meta``, all counted in Python integers.

Memory, per cell (``memory``):
  * the weights, in bf16;
  * decode: the cache ``cache_meta(batch=B, max_len=S)`` and the [B] tokens;
  * prefill: the prompt batch (int64 tokens, plus the prefix or frame
    embeddings in bf16 where the config has them) and, as output, the cache
    the prefill emits and the last position's fp32 logits;
  * train: the port's trainer state (``train/trainer.py``: bf16 params,
    fp32 master, m and v in the params' shapes, the gradients in the
    params' dtype, as autograd gives them), the micro-batch of
    ``cell_policy``'s ``accum`` (tokens and labels) and, when ``accum`` >
    1, the fp32 gradient accumulator.
Activations are not modelled, so every byte count is a lower bound;
``over_budget`` says that even the lower bound exceeds the card's
``HBM_BYTES``.

Roofline: ``model_flops + attention_flops`` over the useful bytes (weights,
and the decode cache), as the JAX dry run counts them, at the H100's peaks
(``analysis/roofline.py``). Results append to ``build/dryrun_torch*.json``
incrementally, one record per cell.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.analysis.roofline import (HBM_BYTES, Roofline,
                                           attention_flops, model_flops)
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, applicable, get_config
from repro_torch.launch.specs import cell_policy
from repro_torch.model import transformer as T
from repro_torch.model.params import tree_leaves
from repro_torch.serve.paged_cache import paged_cache_meta

RESULTS = Path(__file__).resolve().parents[3] / "build"
WEIGHT_DTYPE = torch.bfloat16
TOKEN_BYTES = 8          # the port's token ids are int64
GIB = 2 ** 30


def weight_bytes(ms: T.ModelStructure, dtype=WEIGHT_DTYPE) -> int:
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(T.abstract_params(ms, dtype)))


def meta_elements(meta) -> int:
    """Elements of a per-segment {name: (shape, dtype)} cache meta."""
    return sum(math.prod(shape) for seg in meta for shape, _ in seg.values())


def meta_bytes(meta) -> int:
    return sum(math.prod(shape) * dt.itemsize
               for seg in meta for shape, dt in seg.values())


def engine_bytes(ms: T.ModelStructure, psv, dtype=WEIGHT_DTYPE) -> Dict[str, int]:
    """What a ``PagedEngine`` holds on the device beside its bookkeeping:
    the weights in ``dtype`` and the page pool of ``psv``."""
    pool = paged_cache_meta(ms, n_slots=psv.n_slots, n_pages=psv.n_pages,
                            page_size=psv.page_size, dtype=psv.cache_dtype)
    return {"weights": weight_bytes(ms, dtype), "pool": meta_bytes(pool)}


def batch_bytes(cfg, batch: int, seq: int, *, labels: bool) -> int:
    """The step's batch: tokens (and labels) [batch, seq] int64, the prefix
    or frame embeddings [batch, P or T, D] in the weights' type."""
    n = batch * seq * TOKEN_BYTES * (2 if labels else 1)
    emb = WEIGHT_DTYPE.itemsize
    if cfg.prefix_len:
        n += batch * cfg.prefix_len * cfg.d_model * emb
    if cfg.enc_layers:
        n += batch * cfg.enc_seq * cfg.d_model * emb
    return n


def lower_cell(arch: str, shape_name: str, *, lp: bool = True) -> Dict[str, Any]:
    """The dry-run record of one cell (the JAX package's schema, with
    ``chips`` 1 and ``tp`` 1)."""
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    pol = cell_policy(cfg, shape, lp=lp)
    ms = T.build_structure(cfg, plan=pol.plan, tp=1)
    B, S = shape.global_batch, shape.seq_len
    n_params = T.param_count(ms)
    w_bytes = weight_bytes(ms)
    cache_bytes = out_bytes = state_bytes = accum_bytes = 0
    accum = 1
    if shape.step == "train":
        accum = pol.accum
        micro = max(B // accum, 1)
        b_bytes = batch_bytes(cfg, micro, S, labels=True)
        state_bytes = 3 * 4 * n_params + w_bytes    # master, m, v; gradients
        if accum > 1:
            accum_bytes = 4 * n_params
        useful = 38.0 * n_params   # bf16 fwd+bwd + fp32 m/v/master r+w + grads
    elif shape.step == "prefill":
        b_bytes = batch_bytes(cfg, B, S, labels=False)
        out_bytes = (meta_bytes(T.cache_meta(ms, batch=B, max_len=S))
                     + B * cfg.vocab_size * 4)
        useful = 2.0 * n_params
    else:   # decode
        b_bytes = B * TOKEN_BYTES
        meta = T.cache_meta(ms, batch=B, max_len=S)
        cache_bytes = meta_bytes(meta)
        out_bytes = B * cfg.vocab_size * 4
        useful = 2.0 * n_params + 2.0 * meta_elements(meta)  # bf16 read (+write)
    arg_bytes = w_bytes + cache_bytes + b_bytes + state_bytes
    peak_bytes = arg_bytes + out_bytes + accum_bytes
    mem = {
        "weight_bytes": w_bytes, "cache_bytes": cache_bytes,
        "batch_bytes": b_bytes, "train_state_bytes": state_bytes,
        "argument_bytes": arg_bytes, "output_bytes": out_bytes,
        "accum_buffer_bytes": accum_bytes, "peak_bytes": peak_bytes,
        "argument_gb": arg_bytes / GIB, "output_gb": out_bytes / GIB,
        "temp_gb": None, "accum_buffer_gb": accum_bytes / GIB,
        "peak_gb": peak_bytes / GIB,
        "over_budget": peak_bytes > HBM_BYTES,
        "activations": "not modelled: every byte count is a lower bound",
    }
    mf = model_flops(cfg, shape)
    f_attn = attention_flops(cfg, shape, tp=1)
    rl = Roofline(flops=mf + f_attn, bytes_accessed=useful, coll={},
                  model_flops=mf, chips=1, useful_bytes=useful)
    return {
        "arch": arch, "shape": shape_name, "lp": lp, "multi_pod": False,
        "chips": 1, "tp": 1, "cost_source": "analytic",
        "eff_depth": ms.effective_depth, "n_layers": cfg.n_layers,
        "n_pairs": len(ms.plan.pairs), "n_params": n_params,
        "fsdp": pol.fsdp, "kv_mode": pol.kv_mode, "accum": accum,
        "memory": mem, "coll": {},
        "cost_raw": {"flops": mf, "bytes": useful,
                     "attn_correction_flops": f_attn},
        "roofline": rl.row(),
        "compile_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="not ported: needs ranks (ROADMAP item 10.4)")
    ap.add_argument("--no-lp", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("the multi-pod dry run needs ranks: "
                                  "ROADMAP item 10.4")

    out_path = Path(args.out) if args.out else (
        RESULTS / f"dryrun_torch{'_nolp' if args.no_lp else ''}.json")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    done: Dict[str, Any] = {}
    if out_path.exists():
        done = json.loads(out_path.read_text())

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    for arch in archs:
        for shape in shapes:
            k = f"{arch}/{shape}"
            if k in done and "error" not in done[k] and not args.force:
                print(f"[skip cached] {k}")
                continue
            print(f"[cell] {k} lp={not args.no_lp}", flush=True)
            try:
                rec = lower_cell(arch, shape, lp=not args.no_lp)
            except Exception as e:   # a record per cell; the sweep goes on
                traceback.print_exc()
                rec = {"arch": arch, "shape": shape, "error": str(e)[:500]}
            done[k] = rec
            out_path.write_text(json.dumps(done, indent=1))
            if "roofline" in rec:
                r, m = rec["roofline"], rec["memory"]
                print(f"  ok: bottleneck={r['bottleneck']} "
                      f"t=({r['t_compute_s']:.4f},{r['t_memory_s']:.4f},"
                      f"{r['t_collective_s']:.4f})s "
                      f"roofline={r['roofline_fraction']:.3f} "
                      f"peak>={m['peak_gb']:.2f}GiB"
                      f"{' OVER BUDGET' if m['over_budget'] else ''}",
                      flush=True)
            elif "skipped" in rec:
                print(f"  skipped: {rec['skipped']}")
            else:
                print(f"  ERROR: {rec.get('error', '?')[:200]}")
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
