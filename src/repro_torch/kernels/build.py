"""Build the port's CUDA C++ kernels at first use and load them with ctypes.

Each source in ``repro_torch/csrc`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface. The libraries go to
``build/kernels/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. All missing libraries are compiled at once, one ``nvcc`` process
per source.

Nothing here runs when the module is imported: the CPU build of the
package never compiles or loads a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("decode_attention.cu", "dual_rmsnorm.cu", "flash_attention.cu",
           "ssm_scan.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def _digest(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source, *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"{Path(source).stem}-{_digest(source)}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, all in parallel.
    Returns the seconds each compiled source took (empty when all were
    built already). Raises with the compiler's output on failure; the
    ptxas report of each build is kept beside its library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for src in SOURCES:
        out = library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        procs[src] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter())
    seconds, failed = {}, []
    for src, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)  # atomic: a concurrent builder sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


@functools.cache
def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    build_all()
    return ctypes.CDLL(str(library_path(source)))


def check(rc: int, name: str) -> None:
    """Raise for a non-zero return of a kernel's C entry point."""
    if rc == -1:
        raise ValueError(f"{name}: arguments the kernel does not take")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def strides(x: torch.Tensor, n: int) -> list:
    """The first ``n`` element strides of ``x`` for a kernel's address
    arithmetic. A dim of size 1 is never stepped, so its stride is given as
    0 (torch may report any stride there)."""
    return [s if d > 1 else 0 for d, s in zip(x.shape[:n], x.stride()[:n])]


def aligned16(x: torch.Tensor, n: int) -> bool:
    """True when ``x``'s pointer and its first ``n`` strides (as
    ``strides`` gives them) are multiples of 16 bytes: what a kernel that
    copies rows in 16-byte pieces needs."""
    return x.data_ptr() % 16 == 0 and all(
        s * x.element_size() % 16 == 0 for s in strides(x, n))


def stream_for(device: torch.device) -> int:
    """Handle of the current CUDA stream, for tensors on the current device
    (a kernel launched on another device's stream would be refused)."""
    if device.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {device}, but the current CUDA device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream().cuda_stream
