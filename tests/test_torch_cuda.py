"""The port's hand-written kernels against their plain versions, on an
NVIDIA GPU (CUDA C++ and Triton have no CPU mode): skipped elsewhere.

This file imports only torch and the port, so it runs on a machine without
JAX:  PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
Tolerances: atol = rtol = 2e-5 in fp32, 2e-2 in bf16.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402

DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


# ---------------------------------------------------------------------------
# the kernels themselves (NVIDIA GPU only)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA and Triton kernels run only on an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_gpu(cuda, dtype):
    td, tol = DTYPES[dtype]
    gen = torch.Generator(device=cuda).manual_seed(0)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(td)

    x, sa, sb = rand(40, 96), rand(96), rand(96)
    for got, want in zip(ops.dual_rmsnorm(x, sa, sb), ops.dual_rmsnorm_plain(x, sa, sb)):
        torch.testing.assert_close(got, want, atol=tol, rtol=tol)
    q, k, v = rand(2, 2, 4, 16), rand(2, 50, 2, 16), rand(2, 50, 2, 16)
    for t in (0, 20, 49):
        torch.testing.assert_close(ops.decode_attention(q, k, v, t),
                                   ops.decode_attention_plain(q, k, v, t),
                                   atol=tol, rtol=tol)
    q2, k2, v2 = rand(2, 2, 2, 4, 16), rand(2, 2, 50, 2, 16), rand(2, 2, 50, 2, 16)
    torch.testing.assert_close(ops.decode_attention_pair(q2, k2, v2, 33),
                               ops.decode_attention_pair_plain(q2, k2, v2, 33),
                               atol=tol, rtol=tol)
    q, k, v = rand(2, 37, 2, 4, 32), rand(2, 37, 2, 32), rand(2, 37, 2, 32)
    for kw in ({}, {"kind": "window", "window": 5}, {"kind": "chunk", "chunk": 8},
               {"kind": "bidir"}, {"prefix_len": 3}):
        torch.testing.assert_close(ops.flash_attention(q, k, v, block_n=16, **kw),
                                   ops.flash_attention_plain(q, k, v, **kw),
                                   atol=tol, rtol=tol)
