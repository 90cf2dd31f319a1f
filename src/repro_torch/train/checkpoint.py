"""Fault-tolerant checkpoints in the JAX package's on-disk format.

A checkpoint stores the master weights and AdamW moments in their PARAM
shapes (fp32) plus the step counter: the logical state, which does not
depend on how a run lays its optimizer state out. The format is the JAX
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
from repro_torch.model.params import tree_items, tree_map
from repro_torch.parallel.context import ParallelContext
from repro_torch.train.trainer import (TrainConfig, leaf_infos,
                                       params_from_master)


def logical_like(ms: T.ModelStructure) -> Dict[str, Any]:
    """The tree ``restore`` fills with a checkpoint of ``ms``'s state:
    the logical structure, with the model's parameter descriptors as its
    leaves."""
    tmpl = T.model_template(ms)
    return {"master": tmpl, "m": tmpl, "v": tmpl, "step": 0}


def logical_to_state(logical: Dict[str, Any], ms: T.ModelStructure,
                     pc: ParallelContext, tc: TrainConfig, *,
                     device="cuda") -> Dict[str, Any]:
    """The train state of a restored checkpoint, on ``device`` (the card
    unless the caller asks for "cpu"), with ``params`` cast from the master
    weights."""
    def put(x):
        return torch.as_tensor(x).to(device=device, dtype=torch.float32,
                                     copy=True)

    master = tree_map(put, logical["master"])
    return {
        "params": params_from_master(master, leaf_infos(ms, tc), tc.param_dtype),
        "master": master,
        "m": tree_map(put, logical["m"]),
        "v": tree_map(put, logical["v"]),
        "step": int(logical["step"]),
    }


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
