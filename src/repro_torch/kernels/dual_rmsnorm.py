"""Host side of the LP dual RMSNorm kernel (csrc/dual_rmsnorm.cu).

An LP pair needs both layers' norms of the same residual at each phase
entry; the kernel reads each row of x once and writes both outputs into one
``[2, M, D]`` tensor.

Each row is a block of its own (the grid is M). How a row maps to
threads, and so the order of every sum, is a function of D and the dtype
alone (``row_layout``). A row's bits are therefore the same whatever the
batch, which the engine's bitwise contracts (bucketed == exact prefill,
engine == ``generate``) rest on. Rows, scales and outputs that are 16-byte
aligned are moved in 16-byte vectors, the rest one element at a time, with
the same arithmetic. Every launch is a programmatic dependent launch: the
blocks start while the kernel before drains and wait for it before any
global access. D up to 8192 (the JAX kernel's limit) runs; the
wrapper raises on anything else the kernel does not take.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

SOURCE = "dual_rmsnorm.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192
ROW_WARPS = 8         # warps a row at most (csrc kMaxWarps)


class RowLayout(NamedTuple):
    vec: int              # elements in one 16-byte vector
    warps: int            # warps a row
    vecs_per_thread: int  # vectors a thread holds (at most 8 at D <= 8192)


def row_layout(D: int, dtype: torch.dtype) -> RowLayout:
    """How one row of width D maps to threads: its 16-byte vectors over up
    to 8 warps, a vector a lane before any lane takes a second. A function
    of D and the dtype only, never of the number of rows."""
    vec = 16 // dtype.itemsize
    nv = -(-D // vec)
    warps = min(ROW_WARPS, -(-nv // 32))
    return RowLayout(vec, warps, -(-nv // (32 * warps)))


def check(x: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor) -> bool:
    """Raise on what the kernel does not take; on any device, so that the
    CPU tests reach it. Returns True when every row, scale and output is
    16-byte aligned (16-byte loads and stores), False for the element-wise
    path."""
    if x.dim() != 2:
        raise ValueError(f"dual_rmsnorm kernel takes x as [M, D], got {tuple(x.shape)}")
    M, D = x.shape
    if x.dtype not in DTYPES or sa.dtype != x.dtype or sb.dtype != x.dtype:
        raise TypeError(f"dual_rmsnorm takes float32 or bfloat16 of one type, "
                        f"got {x.dtype}, {sa.dtype}, {sb.dtype}")
    if sa.shape != (D,) or sb.shape != (D,):
        raise ValueError(f"dual_rmsnorm scales {tuple(sa.shape)}, "
                         f"{tuple(sb.shape)} for D={D}")
    if not (0 < M < 2 ** 31 and 0 < D <= MAX_D):
        raise ValueError(f"dual_rmsnorm kernel takes 1 <= M < 2**31 rows and "
                         f"1 <= D <= {MAX_D}, got M={M}, D={D}")
    if (D > 1 and x.stride(1) != 1) or not (sa.is_contiguous() and sb.is_contiguous()):
        raise ValueError("dual_rmsnorm needs contiguous rows and scales")
    vec = row_layout(D, x.dtype).vec
    return (D % vec == 0 and build.aligned16(x, 1) and build.aligned16(sa, 0)
            and build.aligned16(sb, 0))


@functools.cache
def _fn():
    fn = build.library(SOURCE).repro_dual_rmsnorm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(x: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, *,
           eps: float, plus_one: bool) -> torch.Tensor:
    """x: [M, D] CUDA tensor with rows contiguous; sa, sb: [D]. Returns one
    new [2, M, D] tensor of x's dtype: ya and yb, stacked as the pair's
    projections take them."""
    wide = check(x, sa, sb)
    if x.device.type != "cuda" or sa.device != x.device or sb.device != x.device:
        raise ValueError("dual_rmsnorm kernel needs all inputs on one CUDA device")
    M, D = x.shape
    y = torch.empty((2, M, D), dtype=x.dtype, device=x.device)
    rc = _fn()(x.data_ptr(), sa.data_ptr(), sb.data_ptr(), y.data_ptr(),
               DTYPES[x.dtype], M, D, build.strides(x, 1)[0], eps, int(plus_one),
               row_layout(D, x.dtype).warps, int(wide),
               build.stream_for(x.device))
    build.check(rc, "dual_rmsnorm")
    return y


def noop(device: torch.device, *, pdl: bool) -> None:
    """Launch the empty one-block kernel on the current stream: the launch
    floor every small kernel's time is read against. With ``pdl`` it is
    launched as ``launch`` launches the dual RMSNorm (programmatic dependent
    launch, waiting on the kernel before): the floor of such a launch. Not
    counted in ``ops.LAUNCHES``; no path calls it."""
    rc = build.library(SOURCE).repro_noop(
        ctypes.c_int(int(pdl)), ctypes.c_void_p(build.stream_for(device)))
    build.check(rc, "noop")
