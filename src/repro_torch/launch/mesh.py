"""Rank grids and the rank launcher.

Single pod : (data=16, model=16)            — 256 ranks
Multi-pod  : (pod=2, data=16, model=16)     — 512 ranks

``model`` is tensor parallelism (TP + LP live here), ``data`` the data
ranks inside a pod (pure DP + FSDP weight shards), ``pod`` the data ranks
across pods (the gradient sum only, which the trainer can compress to
int8). These are the JAX package's production meshes.

Where the JAX package lays a mesh over the devices of one process, the
port runs one process per rank (``parallel/context.py``). A ``Grid`` is
therefore a descriptor only: its sizes, its axis names and the world ranks
of each group (``grid_ranks``). Building one starts no process and
touches no device. ``spawn_ranks`` starts the ranks of a grid, each in a
process of its own; the dry run (``launch/dryrun.py``) runs one rank's
step of a grid under ``make_dry_context`` instead, with no process.

Nothing here picks a backend for the caller: "nccl" takes one card per
rank (rank r on ``cuda:r``), "gloo" takes CUDA tensors (every rank on card
0) or CPU tensors.
"""
from __future__ import annotations

import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.parallel.context import BACKENDS, grid_ranks

BUILD = Path(__file__).resolve().parents[3] / "build"
SRC = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Grid:
    """A (pod, data, model) rank grid, numbered as ``grid_ranks`` numbers
    it (``(p * data + d) * model + m``, ``jax.make_mesh``'s order)."""
    pod: int = 1
    data: int = 1
    model: int = 1

    def __post_init__(self):
        if min(self.pod, self.data, self.model) < 1:
            raise ValueError(f"grid axes must be >= 1, got {self.shape}")

    @property
    def shape(self) -> Tuple[int, int, int]:
        return (self.pod, self.data, self.model)

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """The JAX mesh's axis names: ("pod", "data", "model"), without
        "pod" on one pod."""
        return ("pod", "data", "model") if self.pod > 1 else ("data", "model")

    @property
    def dp(self) -> int:
        return self.pod * self.data

    def ranks(self) -> Dict[str, List[List[int]]]:
        """{axis: the world ranks of each group of that axis}
        (``parallel.context.grid_ranks``)."""
        return grid_ranks(*self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Grid:
    return Grid(2, 16, 16) if multi_pod else Grid(1, 16, 16)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model")) -> Grid:
    """A small grid; ``axes`` names the entries of ``shape`` (any of "pod",
    "data", "model"; an axis left out has size 1)."""
    if len(shape) != len(axes) or not set(axes) <= {"pod", "data", "model"}:
        raise ValueError(f"grid shape {shape} over axes {axes}")
    return Grid(**dict(zip(axes, shape)))


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """'DxM' -> (data, model) sizes; the command-line mesh grammar of
    launch/serve.py and launch/dryrun.py."""
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec must be DxM (e.g. 1x2), got {spec!r}")
    if d < 1 or m < 1:
        raise ValueError(f"mesh axes must be >= 1, got {spec!r}")
    return d, m


def visible_cards() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def make_serving_mesh(spec: str, *, backend: str = "nccl",
                      device: str = "cuda") -> Tuple[Optional[Grid], int]:
    """(grid | None, model size) from a 'DxM' command-line spec.

    '1x1' is one process on one device (grid None). Any D > 1 is refused:
    serving shards only the model axis (data-parallel serving is engine
    replicas). Under NCCL each of the M ranks takes a card of its own, so
    fewer visible cards than M is an error that names gloo, under which
    the ranks may share one card (or run on the CPU)."""
    d, m = parse_mesh_spec(spec)
    if d > 1:
        raise ValueError(
            f"mesh {spec!r}: serving shards only the model axis; use 1xM "
            "(data-parallel serving means running engine replicas)")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if m == 1:
        return None, 1
    if backend == "nccl":
        n = visible_cards() if device != "cpu" else 0
        if n < m:
            raise ValueError(
                f"mesh {spec} over NCCL needs {m} cards, one a rank, and "
                f"{n} {'is' if n == 1 else 'are'} visible on "
                f"{'the CPU' if device == 'cpu' else 'this machine'}; run "
                "--backend gloo to put the ranks on one card or the CPU")
    return Grid(1, 1, m), m


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------

def _fn_path(fn: Callable) -> Tuple[str, str]:
    """(module, qualified name) a rank process imports ``fn`` by: a
    function defined at the top of an importable module (a module run as
    ``python -m`` is imported under its own name)."""
    module = fn.__module__
    if module == "__main__":
        spec = getattr(sys.modules["__main__"], "__spec__", None)
        if spec is None:
            raise ValueError(f"{fn.__qualname__} is defined in a script: a rank "
                             "process cannot import it; define it in a module")
        module = spec.name
    if "<" in fn.__qualname__:
        raise ValueError(f"{fn.__qualname__}: a rank process imports its "
                         "function by name; define it at module level")
    return module, fn.__qualname__


def rank_device(backend: str, device: str, rank: int) -> str:
    """Where rank ``rank`` places its tensors: its own card under NCCL,
    card 0 under gloo, or the CPU."""
    if device == "cpu":
        return "cpu"
    return f"cuda:{rank}" if backend == "nccl" else "cuda:0"


def spawn_ranks(fn: Callable, grid: Grid, *, backend: str, device: str = "cuda",
                timeout: float = 600.0, workdir=None, **args) -> List[Any]:
    """Run ``fn(pc, device, **args)`` in ``grid.chips`` processes of this
    interpreter, one a rank, and return what each returned, in rank order.

    The ranks meet through a file store in a fresh directory under
    ``workdir`` (default: ``build/ranks`` of the checkout), initialise the
    world with ``backend`` (``init_context``) and build their context on
    the grid (``make_grid_context``; on a grid of the model axis alone the
    world is the tp group). Each places itself (``rank_device``) and runs
    ``fn``, which must be a module-level function; ``args`` and the
    results go by pickle. A rank writes its output to ``rank<r>.log``
    there. A rank that fails, or outlives ``timeout`` seconds, fails the
    call: the other ranks are killed and the error shows that rank's log.
    The directory is removed when every rank succeeded."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    module, name = _fn_path(fn)
    root = Path(workdir) if workdir is not None else BUILD / "ranks"
    root.mkdir(parents=True, exist_ok=True)
    d = Path(tempfile.mkdtemp(prefix="spawn-", dir=root))
    (d / "args.pkl").write_bytes(pickle.dumps(args))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(SRC)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for rank in range(grid.chips):
        spec = {"module": module, "fn": name, "grid": grid.shape, "rank": rank,
                "backend": backend, "device": device, "dir": str(d)}
        with open(d / f"rank{rank}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.mesh", json.dumps(spec)],
                env=env, stdout=log, stderr=subprocess.STDOUT))
    failed = None
    deadline = time.monotonic() + timeout
    try:
        while failed is None:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                failed = (bad[0], f"rank {bad[0]} of {grid.chips} exited with "
                                  f"{codes[bad[0]]}")
            elif all(c == 0 for c in codes):
                break
            elif time.monotonic() > deadline:
                r = codes.index(None)
                failed = (r, f"rank {r} of {grid.chips} ran past {timeout} s")
            else:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed is not None:
        rank, why = failed
        log = (d / f"rank{rank}.log").read_text()
        raise RuntimeError(f"{why} (logs in {d}):\n{log[-6000:]}")
    out = [pickle.loads((d / f"rank{r}.pkl").read_bytes()) for r in range(grid.chips)]
    shutil.rmtree(d, ignore_errors=True)
    return out


def rank_main(spec: Dict[str, Any]) -> None:
    """One rank of ``spawn_ranks``: join the world, build the context, run
    the function, write its result."""
    import importlib
    import torch
    import torch.distributed as dist
    from repro_torch.parallel.context import init_context, make_grid_context
    d, rank = Path(spec["dir"]), spec["rank"]
    pod, data, model = spec["grid"]
    device = rank_device(spec["backend"], spec["device"], rank)
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device))
    pc = init_context(backend=spec["backend"], init_method=f"file://{d / 'store'}",
                      world_size=math.prod(spec["grid"]), rank=rank)
    if pod * data > 1:
        pc = make_grid_context(pod, data, model)
    fn = getattr(importlib.import_module(spec["module"]), spec["fn"])
    out = fn(pc, device, **pickle.loads((d / "args.pkl").read_bytes()))
    if device.startswith("cuda"):
        torch.cuda.synchronize()
    dist.barrier()
    dist.destroy_process_group()
    (d / f"rank{rank}.pkl").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
