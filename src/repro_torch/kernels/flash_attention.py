"""Host side of the flash attention kernel (csrc/flash_attention.cu).

The kernel takes the attention core's grouped layout directly — q and the
output as [B, S, H, g, hd], k and v as [B, T, H, hd] — through strides, so
the GQA fold (row = position * g + head) costs no transpose copy.

bfloat16 runs on the tensor cores and copies rows in 16-byte pieces: it
takes ``block_n`` in 16/32/64/128 and pointers and strides in multiples of
16 bytes, and raises on anything else. float32 runs on the CUDA cores and
takes any ``block_n`` and any strides with hd contiguous.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "flash_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KINDS = {"causal": 0, "window": 1, "chunk": 2, "bidir": 3}
BF16_BLOCK_N = (16, 32, 64, 128)   # the tensor-core body's softmax tiles


@functools.cache
def _fn():
    fn = build.library(SOURCE).repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p] + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, kind: str,
           window: int, chunk: int, prefix_len: int, q0, k0: int,
           block_n: int) -> torch.Tensor:
    """q: [B, S, H, g, hd]; k, v: [B, T, H, hd] CUDA tensors, any strides
    with hd contiguous. ``q0``: an int, or a contiguous int32 tensor [B] of
    per-row query offsets on the same device. Returns a new contiguous
    [B, S, H, g, hd] tensor."""
    B, S, H, G, hd = q.shape
    T = k.shape[1]
    if k.shape != (B, T, H, hd) or v.shape != k.shape:
        raise ValueError(f"flash attention shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash attention kernel needs all inputs on one "
                         "CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash attention needs hd contiguous")
    if hd not in (16, 32, 64, 128):
        raise ValueError(f"flash attention is built for hd in 16/32/64/128, "
                         f"got {hd}")
    if kind not in KINDS or block_n <= 0:
        raise ValueError(f"flash attention kind={kind!r} block_n={block_n}")
    if q.dtype == torch.bfloat16:
        if block_n not in BF16_BLOCK_N:
            raise ValueError(f"bf16 flash attention takes block_n in "
                             f"{BF16_BLOCK_N}, got {block_n}")
        if not (build.aligned16(q, 4) and build.aligned16(k, 3)
                and build.aligned16(v, 3)):
            raise ValueError("bf16 flash attention needs q, k and v pointers "
                             "and strides in multiples of 16 bytes")
    q0_rows = None
    if torch.is_tensor(q0):
        if (q0.shape != (B,) or q0.dtype != torch.int32 or q0.device != q.device
                or not q0.is_contiguous()):
            raise ValueError(f"per-row q0 must be a contiguous int32 [B={B}] "
                             f"tensor on {q.device}, got {tuple(q0.shape)} "
                             f"{q0.dtype} on {q0.device}")
        q0_rows, q0 = q0.data_ptr(), 0
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 14)(*build.strides(q, 4), *build.strides(k, 3),
                                       *build.strides(v, 3), *build.strides(o, 4))
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               DTYPES[q.dtype], B, H, S, G, T, hd, strides, KINDS[kind],
               window, chunk, prefix_len, int(q0), q0_rows, k0, block_n,
               hd ** -0.5,
               build.stream_for(q.device))
    build.check(rc, "flash_attention")
    return o
