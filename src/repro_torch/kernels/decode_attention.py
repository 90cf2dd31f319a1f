"""Host side of the decode attention kernel (csrc/decode_attention.cu).

Each kernel body serves the ring cache and the paged pool, single layer and
pair: a single layer is the pair form with one half (as ``_kernel``/``_launch``
and ``_paged_kernel``/``_launch_paged`` in the JAX package). The cache is
passed in its stored layout with its strides; nothing is transposed,
gathered or padded. The kernel copies cache rows in 16-byte pieces, so the
cache's pointer and strides must be multiples of 16 bytes; the wrapper
raises on anything else. The paged form may take a head map: q's kv head h
then reads the pool's stored head ``head_map[h]`` (a tensor-parallel rank
over replicated kv heads). Each row is split across a cluster of 4 blocks;
a refused cluster launch raises. bf16 runs on the tensor cores, one warp
per 16 query heads of the GQA group (two from hd = 128, each owning half
of the output's columns; any g: a group wider than a block's shared memory
holds is cut into head slices); fp32 on the CUDA cores. hd is one of
``HDS``; any other width raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

SOURCE = "decode_attention.cu"
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HDS = (16, 32, 64, 128, 256)   # the head widths the kernel is instantiated at


@functools.cache
def _fn():
    fn = build.library(SOURCE).repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _paged_fn():
    fn = build.library(SOURCE).repro_decode_attention_paged
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, hd, G):
    """Raise on what the kernel does not take; the head width first, so a
    refused width shows on any device."""
    if hd not in HDS:
        raise ValueError(f"decode attention is built for hd in "
                         f"{'/'.join(map(str, HDS))}, got hd={hd}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode attention takes float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("decode attention kernel needs all inputs on one "
                         "CUDA device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("decode attention needs hd contiguous")
    if G < 1:
        raise ValueError(f"decode attention needs a GQA group g >= 1, got {G}")
    if not (build.aligned16(k, 4) and build.aligned16(v, 4)):
        raise ValueError("decode attention needs the cache's pointers and "
                         "strides in multiples of 16 bytes")


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
    _check(q, k, v, hd, G)
    if t < 0:
        raise ValueError(f"decode attention horizon t={t} < 0")
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 16)(*build.strides(q, 4), *build.strides(k, 4),
                                       *build.strides(v, 4), *build.strides(o, 4))
    rc = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               DTYPES[q.dtype], P, B, H, G, L, hd, strides, int(t),
               hd ** -0.5, build.stream_for(q.device))
    build.check(rc, "decode_attention")
    return o


def check_head_map(head_map: torch.Tensor, H: int, Hs: int,
                   device: torch.device) -> None:
    """Raise unless ``head_map`` is a contiguous int32 tensor [H] on
    ``device`` whose entries are stored heads (0 <= entry < Hs). The
    entries are read once per map (one device sync) and again only after
    the tensor is written in place: a model path keeps one map per rank."""
    if (not torch.is_tensor(head_map) or head_map.dtype != torch.int32
            or head_map.device != device or not head_map.is_contiguous()
            or tuple(head_map.shape) != (H,)):
        raise ValueError(
            f"paged decode needs head_map as a contiguous int32 tensor [{H}] "
            f"on {device}, got "
            + (f"{head_map.dtype} {tuple(head_map.shape)} on {head_map.device}"
               if torch.is_tensor(head_map) else type(head_map).__name__))
    key = (head_map._version, Hs)
    if getattr(head_map, "_checked_for", None) == key:
        return
    lo, hi = (int(x) for x in torch.aminmax(head_map))
    if lo < 0 or hi >= Hs:
        raise ValueError(f"head_map entries span {lo}..{hi}, outside the "
                         f"pool's {Hs} stored heads")
    head_map._checked_for = key


def launch_paged(q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
                 block_tables: torch.Tensor, t: torch.Tensor,
                 head_map: torch.Tensor = None) -> torch.Tensor:
    """q: [P, B, Hkv, g, hd]; k_pages, v_pages: [P, n_pages, ps, Hs, hd]
    CUDA tensors, any strides with hd contiguous; block_tables [B, n_pg]
    and t [B], contiguous int32 on the same device. Row b attends to its
    logical positions 0..t[b] through block_tables[b]; q's kv head h reads
    the pool's stored head ``head_map[h]`` (``check_head_map``), or h
    without a map (then Hs == Hkv). Returns a new contiguous
    [P, B, Hkv, g, hd] tensor."""
    P, B, H, G, hd = q.shape
    n_pages, ps, Hs = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    n_pg = block_tables.shape[-1]
    if (k_pages.shape != (P, n_pages, ps, Hs, hd) or v_pages.shape != k_pages.shape
            or (head_map is None and Hs != H)
            or block_tables.shape != (B, n_pg) or t.shape != (B,)):
        raise ValueError(f"paged decode shapes q {tuple(q.shape)}, pool "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}, "
                         f"block tables {tuple(block_tables.shape)}, "
                         f"t {tuple(t.shape)}")
    _check(q, k_pages, v_pages, hd, G)
    for name, x in (("block_tables", block_tables), ("t", t)):
        if x.dtype != torch.int32 or x.device != q.device or not x.is_contiguous():
            raise ValueError(f"paged decode needs {name} as a contiguous int32 "
                             f"tensor on {q.device}, got {x.dtype} on {x.device}")
    if head_map is not None:
        check_head_map(head_map, H, Hs, q.device)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 16)(*build.strides(q, 4),
                                       *build.strides(k_pages, 4),
                                       *build.strides(v_pages, 4),
                                       *build.strides(o, 4))
    rc = _paged_fn()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     o.data_ptr(), block_tables.data_ptr(), t.data_ptr(),
                     None if head_map is None else head_map.data_ptr(),
                     DTYPES[q.dtype], P, B, H, G, n_pg, ps, hd, strides,
                     hd ** -0.5, build.stream_for(q.device))
    build.check(rc, "decode_attention_paged")
    return o
