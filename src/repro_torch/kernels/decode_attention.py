"""Host side of the ring decode attention kernel (csrc/decode_attention.cu).

One body serves both entry points, as ``_kernel``/``_launch`` do in the JAX
package: a single layer is the pair form with one half. The cache is passed
in its stored layout with its strides; nothing is transposed or padded.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "decode_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn():
    fn = build.library(SOURCE).repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           t: int) -> torch.Tensor:
    """q: [P, B, Hkv, g, hd]; k, v: [P, B, L, Hkv, hd] CUDA tensors, any
    strides with hd contiguous. Positions > t are masked. Returns a new
    contiguous [P, B, Hkv, g, hd] tensor."""
    P, B, H, G, hd = q.shape
    L = k.shape[2]
    if k.shape != (P, B, L, H, hd) or v.shape != k.shape:
        raise ValueError(f"decode attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("decode attention kernel needs all inputs on one "
                         "CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode attention needs hd contiguous")
    if hd not in (16, 32, 64, 128) or G * hd > 2048:
        raise ValueError(f"decode attention is built for hd in 16/32/64/128 "
                         f"and g*hd <= 2048, got hd={hd}, g={G}")
    if t < 0:
        raise ValueError(f"decode attention horizon t={t} < 0")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 16)(*q.stride()[:4], *k.stride()[:4],
                                       *v.stride()[:4], *o.stride()[:4])
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               DTYPES[q.dtype], P, B, H, G, L, hd, strides, int(t),
               hd ** -0.5, build.stream_for(q.device))
    build.check(rc, "decode_attention")
    return o
