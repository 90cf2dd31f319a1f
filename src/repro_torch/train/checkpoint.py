"""Fault-tolerant checkpoints in the JAX package's on-disk format.

A checkpoint stores the master weights and AdamW moments in their PARAM
shapes (fp32) plus the step counter: the logical state, which does not
depend on how a run lays its optimizer state out. ``state_to_logical``
gathers it from the ranks of any grid (flat ZeRO rows, FSDP segments);
``logical_to_state`` re-flattens it for any other (an elastic re-scale, a
change into or out of FSDP); at one rank without FSDP the state is the
logical tree already. The format is the JAX
package's, so each package reads the other's checkpoints with numpy alone:

  <dir>/step_NNNNNNNN/arr_KKKKK.npy   one ``np.save`` file per leaf
  <dir>/step_NNNNNNNN/manifest.json   {"step", "leaves": {path: {"file",
                                      "shape", "dtype", "sha256"}}}
  <dir>/LATEST                        the name of the last whole checkpoint

Leaves are named by their "/"-joined tree path (``master/segments/0/attn/
wq``, ``step``) and numbered in the JAX flatten order (dict keys sorted);
``restore`` looks each one up by its path, never by its file's number.

Durability (a kill at any point leaves the last whole checkpoint):
  1. write every leaf to  <dir>/step_N.tmp/arr_<k>.npy
  2. write manifest.json, fsync it, rename step_N.tmp -> step_N
  3. write LATEST.tmp, fsync it, rename it over LATEST

``AsyncCheckpointer`` runs the writes on a background thread, one save at
a time (a new save waits for the previous one to commit).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.model import transformer as T
from repro_torch.model.params import (local_shape, shard_slice, stack_trees,
                                      tree_items, tree_map)
from repro_torch.parallel import fsdp as F
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.trainer import (TrainConfig, err_init, from_flat_global,
                                       leaf_infos, params_from_master,
                                       to_flat_global)


def logical_like(ms: T.ModelStructure) -> Dict[str, Any]:
    """The tree ``restore`` fills with a checkpoint of ``ms``'s state:
    the logical structure (param-shaped, whatever the layout of ``ms``'s
    segments), with the model's parameter descriptors as its leaves."""
    tmpl = T.model_template(T.regular_structure(ms))
    return {"master": tmpl, "m": tmpl, "v": tmpl, "step": 0}


def _global_leaf(row, pd, pc: ParallelContext):
    """A regular leaf's GLOBAL fp32 tensor from the ranks' rows: gathered
    into the flat (dp, tp, chunk) layout (over tp only where the leaf is
    split), then ``from_flat_global``."""
    flat = pc.all_gather_dp(row.reshape(1, -1), axis=0)
    flat = (pc.all_gather_tp(flat, axis=1, tiled=False) if pd.split is not None
            else flat.unsqueeze(1).expand(-1, pc.tp_size, -1))
    return from_flat_global(flat, pd.shape, pd.split, pc, pd.parts)


def _seg_to_regular(flat_seg, seg, meta, ms: T.ModelStructure, pc: ParallelContext):
    """A rank's FSDP views of one segment -> its GLOBAL regular stacked
    tree (count, ...): gathered over data and tp, then unpacked."""
    full = tree_map(lambda x: pc.all_gather_tp(pc.all_gather_data(x, axis=1), axis=2),
                    flat_seg)
    groups = F.unpack_segment(full, meta, data=ms.fsdp_data, tp=ms.tp)
    return groups[0] if seg.count == 1 else stack_trees(groups)


@torch.no_grad()
def gather_logical(tree, ms: T.ModelStructure, pc: ParallelContext):
    """A tree in the layout of a rank's ``state["master"]`` (its rows and
    FSDP views) -> the GLOBAL param-shaped fp32 tree, the same on every
    rank. Every rank of the grid calls it (its collectives run on all of
    them)."""
    tmpl = T.model_template(ms)
    out = {k: tree_map(lambda r, pd: _global_leaf(r, pd, pc), tree[k], tmpl[k])
           for k in tree if not (ms.fsdp and k == "segments")}
    if ms.fsdp:
        out["segments"] = [_seg_to_regular(fs, seg, meta, ms, pc)
                           for fs, seg, meta in zip(tree["segments"], ms.segments,
                                                    T.segment_metas(ms))]
    return out


def state_to_logical(state: Dict[str, Any], ms: T.ModelStructure,
                     pc: ParallelContext) -> Dict[str, Any]:
    """This rank's train state -> {"master", "m", "v": GLOBAL param-shaped
    fp32 trees, "step"}, the same on every rank (``gather_logical``)."""
    return {**{k: gather_logical(state[k], ms, pc)
               for k in ("master", "m", "v")}, "step": state["step"]}


def logical_to_state(logical: Dict[str, Any], ms: T.ModelStructure,
                     pc: ParallelContext, tc: TrainConfig, *,
                     device="cuda") -> Dict[str, Any]:
    """This rank's train state of a restored checkpoint (GLOBAL param-shaped
    trees, from any grid) on ``device`` (the card unless the caller asks
    for "cpu"): re-flattened under ``pc``'s grid and ``ms``'s layout, with
    ``params`` cast from the master weights. No collective."""
    infos = leaf_infos(ms, tc)
    reg_tmpl = T.model_template(T.regular_structure(ms))
    t = pc.tp_index()

    def full(tree):
        return tree_map(lambda x: torch.as_tensor(x).to(
            device=device, dtype=torch.float32, copy=True), tree)

    def rank_part(tree, regular_leaf):
        out = {k: tree_map(regular_leaf, tree[k], reg_tmpl[k])
               for k in tree if not (ms.fsdp and k == "segments")}
        if ms.fsdp:
            out["segments"] = T.pack_rank_segments(tree["segments"], ms, t,
                                                   pc.data_index())
        return out

    def shard(x, pd):
        return x[shard_slice(x.shape, pd.split, ms.tp, t, pd.parts)]

    def row(x, pd):
        r = to_flat_global(x, pd.split, pc, pd.parts)[pc.dp_index(), t]
        # at dp = 1 the row is the whole tp-local leaf: kept in its shape
        return (r.reshape(local_shape(pd, ms.tp)) if pc.dp_size == 1 else r).clone()

    params = rank_part(full(logical["master"]), shard)
    state = {
        "params": params_from_master(params, infos, tc.param_dtype),
        **{k: rank_part(full(logical[k]), row) for k in ("master", "m", "v")},
        "step": int(logical["step"]),
    }
    if tc.compress_pod:
        state["err"] = err_init(params, infos, pc)   # EF restarts at zero
    return state


def _to_numpy(x) -> np.ndarray:
    """A host copy of a leaf: a tensor's values (never a view of a tensor
    the run goes on writing), or a Python number as the JAX package's
    int32 / float32 scalar."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    if isinstance(x, (int, np.integer)):
        return np.asarray(x, np.int32)
    if isinstance(x, (float, np.floating)):
        return np.asarray(x, np.float32)
    return np.asarray(x)


def _sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _stored(state: Dict[str, Any]) -> Dict[str, Any]:
    """What a checkpoint holds of a tree: all of it but a train state's
    ``params``, which are the master weights cast (``logical_to_state``
    casts them again)."""
    return {k: x for k, x in state.items() if k != "params"}


def save(ckpt_dir: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` (a train state, or any tree of tensors and numbers)
    as checkpoint ``step``; returns its directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    name = f"step_{step:08d}"
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": int(step), "leaves": {}}
    for i, (key, leaf) in enumerate(tree_items(_stored(state))):
        arr = _to_numpy(leaf)
        fn = f"arr_{i:05d}.npy"
        path = os.path.join(tmp, fn)
        np.save(path, arr)
        manifest["leaves"][key] = {
            "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": _sha256(path),
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(latest_tmp, os.path.join(ckpt_dir, "LATEST"))
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The step LATEST names, if its checkpoint is whole; else None."""
    p = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        name = f.read().strip()
    if not os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore(ckpt_dir: str, like, *, step: Optional[int] = None):
    """Load checkpoint ``step`` (default: LATEST) into the tree structure of
    ``like``: each leaf, found by its path, as a CPU tensor. A leaf whose
    sha256 differs from the manifest's raises."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for key, _ in tree_items(like):
        meta = manifest["leaves"][key]
        path = os.path.join(d, meta["file"])
        if _sha256(path) != meta["sha256"]:
            raise AssertionError(f"corrupt leaf {key} in {d}")
        loaded[key] = torch.from_numpy(np.load(path))
    paths = iter(key for key, _ in tree_items(like))
    return tree_map(lambda _: loaded[next(paths)], like)


class AsyncCheckpointer:
    """Background checkpoint writer with a queue of one: a new save waits
    for the previous one to commit (backpressure instead of unbounded
    memory). The host copy is taken on the caller's thread, so the run may
    go on updating its state in place."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, state: Dict[str, Any], step: int) -> None:
        self.wait()
        host = tree_map(_to_numpy, _stored(state))

        def work():
            try:
                save(self.ckpt_dir, host, step)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the pending save has committed; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.ckpt_dir)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)
