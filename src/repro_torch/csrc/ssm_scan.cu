// Selective scan: the linear recurrence h_t = a_t * h_{t-1} + b_t of the
// Mamba-1 mixer (N = ssm_state) and RG-LRU (N = 1), for every (row, c, n)
// element of a, b [R, S, C, N] from h0 [R, C, N]. Writes every h_t to y in
// a's type and h_S to hT in fp32.
//
// Replaces: the JAX package's kernels/ssm_scan.py, `_kernel` behind
// `ssm_scan`. The TPU kernel runs a log-depth associative scan inside VMEM
// tiles of (block_s x block_c) and carries h between sequence tiles through
// scratch while the grid walks S in order: a layout for the TPU's vector
// unit. None of that carries over.
//
// What bounds it on the card: bytes. Each element of a and b is read once
// and each h_t written once, for one multiply and one add: 2 flops per
// 12 bytes in fp32, far below the ~20 flops per byte at which the H100's
// fp32 units would become the limit.
//
// What the design does about it:
//  * One thread per (row, c, n) element, walking s = 0..S-1 in order with
//    h in a register: no carry crosses threads or blocks, and no scan tree
//    does more than the S multiply-adds the recurrence needs.
//  * Elements are numbered with n innermost, as they lie in memory, so at
//    every s a warp reads 32 consecutive values of a and of b and writes 32
//    of y: whole 128-byte lines in fp32.
//  * The loads of a and b do not depend on h, so the unrolled loop keeps
//    several steps' loads in flight while the multiply-adds chain.
//  * __fmul_rn and __fadd_rn keep the multiply and the add separately
//    rounded (no contraction into an FMA), so in fp32 the kernel rounds
//    exactly as the plain version's `a * h` then `+ b`: bit for bit.
//
// Known limit: the grid has R * C * N threads. At the engine's B = 1
// prefill (C = 8192, N = 16) that is 131,072 threads, about half of the
// H100's resident thread slots. Splitting S with a carry pass is later work.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                    const float* __restrict__ h0, T* __restrict__ y,
                    float* __restrict__ hT, int S, long long CN) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= CN) return;
  const long long row = blockIdx.y;
  const long long base = row * S * CN + e;
  float h = h0[row * CN + e];
#pragma unroll 8
  for (int s = 0; s < S; ++s) {
    const long long off = base + static_cast<long long>(s) * CN;
    h = __fadd_rn(__fmul_rn(to_float(a[off]), h), to_float(b[off]));
    y[off] = from_float<T>(h);
  }
  hT[row * CN + e] = h;
}

template <typename T>
int launch(const void* a, const void* b, const float* h0, void* y, float* hT,
           int R, int S, long long CN, cudaStream_t stream) {
  const long long blocks = (CN + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return -1;
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(R));
  ssm_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(y), hT, S, CN);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b, y: contiguous [R, S, C*N] in the type `dtype` names; h0, hT:
// contiguous fp32 [R, C*N]. Returns 0 on success, a cudaError_t code after
// a failed launch, or -1 for arguments the kernel does not take (the Python
// wrapper checks first).
extern "C" int repro_ssm_scan(const void* a, const void* b, const float* h0,
                              void* y, float* hT, int dtype, int R, int S,
                              long long CN, void* stream) {
  if (R <= 0 || R > 65535 || S <= 0 || CN <= 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return launch<float>(a, b, h0, y, hT, R, S, CN, s);
  if (dtype == kBFloat16)
    return launch<__nv_bfloat16>(a, b, h0, y, hT, R, S, CN, s);
  return -1;
}
