"""Dry run: the memory, roofline and collective story of every
(architecture x input shape) cell, at one NVIDIA H100 (tp = 1) or at one
rank of a (pod, data, model) grid of H100s, without running a step on a
device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--no-lp]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh 16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

The JAX package's dry run lowers and compiles each cell over a TPU mesh and
reads XLA's ``cost_analysis``, ``memory_analysis`` and the collectives of
the partitioned HLO. PyTorch has no counterpart of the first two, so the
memory and cost numbers here are analytic (``"cost_source": "analytic"``)
and allocate nothing: the weights come from ``transformer.abstract_params``
(meta tensors), the decode cache from ``transformer.cache_meta``, all
counted in Python integers.

Memory, per cell and rank (``memory``):
  * the weights, in bf16 (at a grid the rank's tp shard, FSDP by the
    policy: the rank's flat (count, 1, 1, chunk) views);
  * decode: the cache ``cache_meta(batch=B, max_len=S)`` and the [B] tokens
    (at a grid the rank's rows and its cache shard, ``specs.decode_specs``);
  * prefill: the prompt batch (int64 tokens, plus the prefix or frame
    embeddings in bf16 where the config has them) and, as output, the cache
    the prefill emits and the last position's fp32 logits;
  * train: the port's trainer state (``train/trainer.py``: bf16 params,
    fp32 master, m and v in the params' shapes (at a grid the rank's flat
    ZeRO rows), the gradients in the params' dtype, as autograd gives
    them), the micro-batch of ``cell_policy``'s ``accum`` (tokens and
    labels) and, when ``accum`` > 1, the fp32 gradient accumulator.
Activations are not modelled, so every byte count is a lower bound;
``over_budget`` says that even the lower bound exceeds the card's
``HBM_BYTES``.

Roofline: ``model_flops + attention_flops`` (over the ranks) against the
useful bytes (weights, and the decode cache), as the JAX dry run counts
them, at the H100's peaks (``analysis/roofline.py``).

Collectives (``--mesh DxM`` or ``--multi-pod``, JAX's (16, 16) and (2, 16,
16)): rank 0's step of the cell runs on meta tensors under
``parallel.context.make_dry_context``, whose groups record each collective
and communicate nothing (the kernels' wrappers return empty outputs on
meta), so no process starts and no card is touched. ``coll`` is
``roofline.collective_bytes`` of the record (``"coll_source":
"recorded"``): train runs the port's train step on the micro-batch, and
the micro-step's collectives (forward, backward) scale by ``accum`` while
the once-per-step gradient reduction does not, as JAX's dry run scales
them; prefill runs the prefill (sequence parallel by the policy); decode
one serve step on ``decode_specs``'s cache. At "1x1" the records are the
one-card ones, with no collective.

Results append to ``build/dryrun_torch*.json`` incrementally, one record
per cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch

from repro_torch.analysis.roofline import (HBM_BYTES, Roofline,
                                           attention_flops, collective_bytes,
                                           model_flops)
from repro_torch.configs import ASSIGNED_ARCHS, SHAPES, applicable, get_config
from repro_torch.launch.mesh import (Grid, make_production_mesh,
                                     parse_mesh_spec)
from repro_torch.launch.specs import (batch_specs, build_cell_structure,
                                      cell_policy, decode_specs)
from repro_torch.model import transformer as T
from repro_torch.model.params import as_tree, tree_leaves
from repro_torch.parallel import context as C
from repro_torch.serve.engine import ServeConfig, make_prefill, make_serve_step
from repro_torch.serve.paged_cache import paged_cache_meta

RESULTS = Path(__file__).resolve().parents[3] / "build"
WEIGHT_DTYPE = torch.bfloat16
TOKEN_BYTES = 8          # the port's token ids are int64
GIB = 2 ** 30


def tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def weight_bytes(ms: T.ModelStructure, dtype=WEIGHT_DTYPE) -> int:
    return tensor_bytes(T.abstract_params(ms, dtype))


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


def memory_row(w_bytes, cache_bytes, b_bytes, state_bytes, out_bytes,
               accum_bytes) -> Dict[str, Any]:
    """A record's ``memory``: the arguments (weights, cache, batch, trainer
    state), the outputs and the gradient accumulator, in bytes and GiB."""
    arg_bytes = w_bytes + cache_bytes + b_bytes + state_bytes
    peak_bytes = arg_bytes + out_bytes + accum_bytes
    return {
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


def lower_cell(arch: str, shape_name: str, *, lp: bool = True,
               grid: Grid = None) -> Dict[str, Any]:
    """The dry-run record of one cell (the JAX package's schema): at one
    card (``grid`` None or of one rank; ``chips`` 1, ``tp`` 1), or at rank
    0 of ``grid`` (``lower_grid_cell``)."""
    if grid is not None and grid.chips > 1:
        return lower_grid_cell(arch, shape_name, lp=lp, grid=grid)
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
    mem = memory_row(w_bytes, cache_bytes, b_bytes, state_bytes, out_bytes,
                     accum_bytes)
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


def _micro_and_step_records(ms, pc, tc, state, batch):
    """(micro-step records, once-per-step records) of one train step of
    ``make_train_step`` on ``batch``: the forward and backward alone are run
    first, and the step's record must begin with theirs."""
    from repro_torch.train.trainer import leaf_infos, make_train_step
    flat = tree_leaves(as_tree(state["params"]))
    leaves = [x for x, li in zip(flat, leaf_infos(ms, tc)) if li.trainable]
    C.reset_all_reduces()
    loss, _ = T.loss_fn(as_tree(state["params"]), batch, ms=ms, pc=pc,
                        remat=tc.remat, differentiable=True)
    torch.autograd.grad(loss, leaves)
    micro = C.recorded()
    C.reset_all_reduces()
    make_train_step(ms, pc, tc)(state, batch)
    step = C.recorded()
    if step[:len(micro)] != micro:
        raise AssertionError("the train step's collectives do not begin with "
                             "its forward and backward's")
    return micro, step[len(micro):]


def _train_coll(micro, grad, accum: int) -> Dict[str, float]:
    """The step's collective bytes: the micro-step's ``accum`` times, the
    gradient reduction once (``grad_reduction``, its bytes)."""
    m, g = collective_bytes(micro), collective_bytes(grad)
    out = {k: accum * m.get(k, 0) + g.get(k, 0) for k in {**m, **g}}
    out["grad_reduction"] = g.get("total", 0.0)
    return out


def lower_grid_cell(arch: str, shape_name: str, *, lp: bool = True,
                    grid: Grid) -> Dict[str, Any]:
    """The dry-run record of one cell at rank 0 of ``grid``: its step on
    meta tensors under a dry context, the rank's memory and the recorded
    collectives (module docstring)."""
    from repro_torch.train import OptConfig, TrainConfig
    from repro_torch.train.trainer import state_from_params
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}
    pod, data, model = grid.shape
    dp, chips = grid.dp, grid.chips
    pol = cell_policy(cfg, shape, tp=model, dp=dp, lp=lp)
    ms = build_cell_structure(cfg, shape, pol, tp=model, data=data)
    pc = C.make_dry_context(pod, data, model, rank=0)
    B, S = shape.global_batch, shape.seq_len
    n_params = T.param_count(T.regular_structure(ms))
    params = T.abstract_params(ms, WEIGHT_DTYPE, rank=0)
    w_bytes = tensor_bytes(params)
    rank_params = sum(t.numel() for t in tree_leaves(params))
    cache_bytes = out_bytes = state_bytes = accum_bytes = 0
    accum = 1
    V = -(-cfg.vocab_size // model)     # the rank's logits
    C.reset_all_reduces()
    if shape.step == "train":
        accum = pol.accum
        micro_shape = dataclasses.replace(shape, global_batch=max(B // accum, 1))
        batch = batch_specs(cfg, micro_shape, pol, dp=dp)
        b_bytes = tensor_bytes(batch)
        tc = TrainConfig(opt=OptConfig(), accum=1, remat=pol.remat,
                         param_dtype=WEIGHT_DTYPE)
        state = state_from_params(T.abstract_params(ms, torch.float32, rank=0),
                                  ms, pc, tc)
        state_bytes = (tensor_bytes([state[k] for k in ("master", "m", "v")])
                       + w_bytes)             # the gradients, as the params
        if accum > 1:
            accum_bytes = tensor_bytes(state["master"])
        micro, grad = _micro_and_step_records(ms, pc.with_sp(pol.sp), tc, state,
                                              batch)
        records = micro + grad
        coll = _train_coll(micro, grad, accum)
        useful = 38.0 * rank_params
    elif shape.step == "prefill":
        batch = batch_specs(cfg, shape, pol, dp=dp)
        b_bytes = tensor_bytes(batch)
        rows = batch["tokens"].shape[0]
        sv = ServeConfig(max_len=S, kv_mode=pol.kv_mode)
        with torch.no_grad():
            _, caches = make_prefill(ms, pc.with_sp(pol.sp), sv)(
                params, batch["tokens"], batch.get("prefix"), batch.get("frames"))
        out_bytes = tensor_bytes(caches) + rows * V * 4
        records = C.recorded()
        coll = collective_bytes(records)
        useful = 2.0 * rank_params
    else:   # decode
        tok, caches, t = decode_specs(cfg, shape, pol, ms, dp=dp)
        b_bytes = tensor_bytes(tok)
        cache_bytes = tensor_bytes(caches)
        sv = ServeConfig(max_len=S, kv_mode=pol.kv_mode)
        with torch.no_grad():
            make_serve_step(ms, pc, sv)(params, tok, caches, t)
        out_bytes = tok.shape[0] * V * 4
        records = C.recorded()
        coll = collective_bytes(records)
        useful = 2.0 * rank_params + 2.0 * sum(c.numel() for c in tree_leaves(caches))
    C.reset_all_reduces()
    mem = memory_row(w_bytes, cache_bytes, b_bytes, state_bytes, out_bytes,
                     accum_bytes)
    mf = model_flops(cfg, shape)
    f_attn = attention_flops(cfg, shape, tp=model)
    flops = (mf + f_attn) / chips
    rl = Roofline(flops=flops, bytes_accessed=useful, coll=coll,
                  model_flops=mf, chips=chips, useful_bytes=useful)
    return {
        "arch": arch, "shape": shape_name, "lp": lp, "multi_pod": pod > 1,
        "grid": list(grid.shape), "chips": chips, "tp": model,
        "cost_source": "analytic", "coll_source": "recorded",
        "eff_depth": ms.effective_depth, "n_layers": cfg.n_layers,
        "n_pairs": len(ms.plan.pairs), "n_params": n_params,
        "rank_params": rank_params,
        "fsdp": pol.fsdp, "kv_mode": pol.kv_mode, "accum": accum,
        "memory": mem, "coll": coll, "coll_records": len(records),
        "cost_raw": {"flops": flops, "bytes": useful,
                     "attn_correction_flops": f_attn / chips},
        "roofline": rl.row(),
        "compile_s": round(time.time() - t0, 1),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="DxM: rank 0 of a (data D, model M) grid; 16x16 is "
                         "the JAX package's pod (default 1x1, one card)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="rank 0 of the (pod 2, data 16, model 16) grid")
    ap.add_argument("--no-lp", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod and args.mesh is not None:
        ap.error("--multi-pod is its own grid: give it without --mesh")
    grid = (make_production_mesh(multi_pod=True) if args.multi_pod
            else Grid(1, *parse_mesh_spec(args.mesh or "1x1")))

    suffix = ("_mp" if args.multi_pod else f"_{grid.data}x{grid.model}"
              if grid.chips > 1 else "")
    out_path = Path(args.out) if args.out else (
        RESULTS / f"dryrun_torch{suffix}{'_nolp' if args.no_lp else ''}.json")
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
            print(f"[cell] {k} grid={grid.shape} lp={not args.no_lp}", flush=True)
            try:
                rec = lower_cell(arch, shape, lp=not args.no_lp, grid=grid)
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
