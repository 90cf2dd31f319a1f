"""LP dual RMSNorm — Triton kernel and its host side.

Replaces: the JAX package's kernels/dual_rmsnorm.py, ``dual_rmsnorm``
(its ``_kernel`` behind the one pallas_call).

An LP pair needs both layers' norms of the same residual at each phase
entry. The kernel reads each row of x once, keeps the fp32 statistics in
registers and writes both outputs in the same pass.

What bounds it on the card: bytes. It is one row reduction and an
elementwise scale, a few flops per element against 3 elements moved (x in,
two outputs). One program per row keeps the whole row (D = 2048 on the main
path) in one block, so x is read once and each output written once; Triton's
masked block loads and ``tl.sum`` reach the bandwidth a CUDA version would,
which is why this kernel, unlike the attention kernels, is Triton.

``triton`` is imported inside ``_kernel`` at first launch: the CPU build of
the package has no triton, and importing this module must not need it.
"""
import functools

import torch

from repro_torch.kernels import build

triton = None  # bound at first launch by _kernel()
tl = None


@functools.cache
def _kernel():
    global triton, tl
    import triton
    import triton.language as tl

    @triton.jit
    def dual_rmsnorm_kernel(x_ptr, sa_ptr, sb_ptr, ya_ptr, yb_ptr, D,
                            x_stride, y_stride, eps,
                            PLUS_ONE: tl.constexpr, BLOCK_D: tl.constexpr):
        row = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < D
        x = tl.load(x_ptr + row * x_stride + cols, mask=mask,
                    other=0.0).to(tl.float32)
        inv = 1.0 / tl.sqrt(tl.sum(x * x, axis=0) / D + eps)
        xn = x * inv
        sa = tl.load(sa_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        sb = tl.load(sb_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        if PLUS_ONE:
            sa = sa + 1.0
            sb = sb + 1.0
        tl.store(ya_ptr + row * y_stride + cols,
                 (xn * sa).to(ya_ptr.dtype.element_ty), mask=mask)
        tl.store(yb_ptr + row * y_stride + cols,
                 (xn * sb).to(yb_ptr.dtype.element_ty), mask=mask)

    return dual_rmsnorm_kernel


def launch(x: torch.Tensor, sa: torch.Tensor, sb: torch.Tensor, *,
           eps: float, plus_one: bool):
    """x: [M, D] CUDA tensor with rows contiguous; sa, sb: [D]. Returns one
    new [2, M, D] tensor of x's dtype: ya and yb, stacked as the pair's
    projections take them."""
    M, D = x.shape
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dual_rmsnorm takes float32 or bfloat16, got {x.dtype}")
    if sa.shape != (D,) or sb.shape != (D,):
        raise ValueError(f"dual_rmsnorm scales {tuple(sa.shape)}, "
                         f"{tuple(sb.shape)} for D={D}")
    if x.device.type != "cuda" or sa.device != x.device or sb.device != x.device:
        raise ValueError("dual_rmsnorm kernel needs all inputs on one CUDA device")
    if x.stride(1) != 1 or not sa.is_contiguous() or not sb.is_contiguous():
        raise ValueError("dual_rmsnorm needs contiguous rows and scales")
    kern = _kernel()
    y = torch.empty((2, M, D), dtype=x.dtype, device=x.device)
    block_d = triton.next_power_of_2(D)
    build.stream_for(x.device)  # Triton launches on the current device's stream
    kern[(M,)](x, sa, sb, y[0], y[1], D, x.stride(0), y.stride(1), eps,
               PLUS_ONE=plus_one, BLOCK_D=block_d,
               num_warps=4 if block_d <= 1024 else 8)
    return y
