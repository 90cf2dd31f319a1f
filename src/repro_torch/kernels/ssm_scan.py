"""Host side of the selective-scan kernel (csrc/ssm_scan.cu).

The kernel takes a, b and y as contiguous [R, S, C*N] and h0, hT as
contiguous fp32 [R, C*N]; the wrapper checks that and allocates the
outputs. Nothing is padded: any S and any C, N run as they are.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "ssm_scan.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = build.library(SOURCE).repro_ssm_scan
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor):
    """a, b: [R, S, C, N] contiguous CUDA tensors of one type (fp32 or
    bf16); h0: [R, C, N] contiguous fp32 on the same device. Returns new
    tensors (y [R, S, C, N] in a's type, hT [R, C, N] fp32)."""
    if a.dim() != 4 or b.shape != a.shape or h0.shape != (a.shape[0], *a.shape[2:]):
        raise ValueError(f"ssm_scan shapes a {tuple(a.shape)}, b {tuple(b.shape)}, "
                         f"h0 {tuple(h0.shape)}")
    if a.dtype not in DTYPES or b.dtype != a.dtype or h0.dtype != torch.float32:
        raise TypeError(f"ssm_scan takes a, b in float32 or bfloat16 and h0 in "
                        f"float32, got {a.dtype}, {b.dtype}, {h0.dtype}")
    if a.device.type != "cuda" or b.device != a.device or h0.device != a.device:
        raise ValueError("ssm_scan kernel needs all inputs on one CUDA device")
    if not (a.is_contiguous() and b.is_contiguous() and h0.is_contiguous()):
        raise ValueError("ssm_scan kernel needs contiguous a, b and h0")
    R, S, C, N = a.shape
    if not (0 < R <= 65535 and S > 0 and C * N > 0):
        raise ValueError(f"ssm_scan kernel takes 1..65535 rows and non-empty "
                         f"S, C, N, got {tuple(a.shape)}")
    y = torch.empty_like(a)
    hT = torch.empty_like(h0)
    rc = _fn()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), y.data_ptr(),
               hT.data_ptr(), DTYPES[a.dtype], R, S, C * N,
               build.stream_for(a.device))
    build.check(rc, "ssm_scan")
    return y, hT
