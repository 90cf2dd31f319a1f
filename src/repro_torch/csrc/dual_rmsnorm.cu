// LP dual RMSNorm: both per-path RMSNorms of an LP pair from one read of x.
//
//   inv = rsqrt(mean(x^2) + eps)             fp32 statistics
//   ya  = x * inv * sa,  yb = x * inv * sb   (1 + s when plus_one)
//
// written in x's type as one [2, M, D] tensor (ya rows, then yb rows), the
// layout the pair projections take.
//
// Replaces: the JAX package's kernels/dual_rmsnorm.py, `_kernel` behind the
// one pallas_call of `dual_rmsnorm`. The TPU kernel holds a tile of 128 rows
// in VMEM and lets the vector unit reduce each row; none of that carries
// over.
//
// What bounds it on the card:
//  * decode rows (M = 4 or 8): latency. 4 rows of D = 2048 in bf16 move
//    48 KB, about 15 ns at 3.35 TB/s; the launch, one round trip to memory
//    and the row reduction's dependent chain are all the time there is.
//  * prefill rows (M = 97 to 2048): bytes. Each element of x is read once
//    and two outputs are written, for a handful of flops.
//
// What the design does about it:
//  * One row order for every M. A row is cut into 16-byte vectors (8 bf16
//    or 4 fp32 values), spread over min(8, ceil(vectors / 32)) warps; the
//    row's threads take vector k * threads + t, so neighbouring lanes read
//    neighbouring addresses. Every sum's order follows from D and the
//    dtype alone: each thread sums its elements in order, each warp by a
//    butterfly of shuffles, and the row adds its warps' sums in warp order.
//    Each row is a block of its own and M sets only the grid, so a row's
//    bits are the same in a 1-row, an 8-row and a 2048-row launch.
//  * Latency. A warp issues one instruction a cycle, so a row held by one
//    warp (64 elements a lane at D = 2048) spends its time issuing the
//    per-element work; 8 warps a row cut that eightfold for one barrier.
//    D = 2048 in bf16 is one vector a thread, D = 4096 two (four in fp32).
//    Every load of a thread is issued before the first is used, sa and sb
//    first, so one round trip to memory covers the row. After the sum the
//    chain is a multiply by 1/D (computed before the loads), an
//    add and the hardware rsqrt (within 2 ulp, as the JAX kernel's
//    lax.rsqrt), not a correctly rounded divide, sqrt and reciprocal.
//  * Bytes. 16-byte loads and stores, x through L2 only (it is read once).
//    A thread holds its whole share of the row (3 x 16 bytes a vector), so
//    x is read once.
//  * Programmatic dependent launch, always: the grid may start while the
//    kernel before it drains, which hides part of the launch between the
//    path's neighbours (a residual add before, a GEMM after). Every global
//    access waits on griddepcontrol.wait: x comes from the kernel before, y
//    may reuse memory that kernel still reads, and the launch cannot know
//    that sa and sb were not written just before either.
//  * A row, scale or output that is not 16-byte aligned (D not a multiple
//    of the vector, or sb = the second row of a [2, D] pair of scales at
//    such a D) is read and written one element at a time. The values land
//    in the same registers and meet the same arithmetic, so the bits do
//    not depend on which loads were taken.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace repro;

namespace {

constexpr int kMaxVecs = 8;    // 16-byte vectors a thread holds
constexpr int kMaxWarps = 8;   // warps a row (a block)
constexpr int kMaxD = 8192;

template <typename T>
struct alignas(16) Pack {
  static constexpr int n = 16 / sizeof(T);
  T v[n];
};

struct NormArgs {
  const void* x;
  const void* sa;
  const void* sb;
  void* y;
  long long x_stride;   // elements between rows of x
  int M, D, warps;
  float eps;
  int plus_one;
};

__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void allow_next_grid() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ float ld_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_cg(const __nv_bfloat16* p) {
  const unsigned short u = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return *reinterpret_cast<const __nv_bfloat16*>(&u);
}

// Vector v of a row (elements v*n .. v*n + n - 1); elements at or past D
// read as 0. kWide: one 16-byte load (D % n == 0, row 16-byte aligned).
// kOnce: x, read once, through L2 only; else the scales, through L1.
template <typename T, bool kWide, bool kOnce>
__device__ __forceinline__ Pack<T> load_pack(const T* __restrict__ row, int v,
                                             int D) {
  Pack<T> p;
  if constexpr (kWide) {
    const uint4* src = reinterpret_cast<const uint4*>(row) + v;
    *reinterpret_cast<uint4*>(p.v) = kOnce ? __ldcg(src) : __ldg(src);
  } else {
#pragma unroll
    for (int j = 0; j < Pack<T>::n; ++j) {
      const int e = v * Pack<T>::n + j;
      p.v[j] = e < D ? (kOnce ? ld_cg(row + e) : row[e]) : from_float<T>(0.f);
    }
  }
  return p;
}

template <typename T, bool kWide>
__device__ __forceinline__ void store_pack(T* __restrict__ row, int v, int D,
                                           const Pack<T>& p) {
  if constexpr (kWide) {
    reinterpret_cast<uint4*>(row)[v] = *reinterpret_cast<const uint4*>(p.v);
  } else {
#pragma unroll
    for (int j = 0; j < Pack<T>::n; ++j) {
      const int e = v * Pack<T>::n + j;
      if (e < D) row[e] = p.v[j];
    }
  }
}

// Rounds a pair of floats to x's type and stores them as elements j, j + 1
// of `p` (round to nearest even, as torch's cast).
template <typename T>
__device__ __forceinline__ void put2(Pack<T>& p, int j, float lo, float hi) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    *reinterpret_cast<__nv_bfloat162*>(p.v + j) = __floats2bfloat162_rn(lo, hi);
  } else {
    p.v[j] = lo;
    p.v[j + 1] = hi;
  }
}

// ya = x * inv * sa and yb = x * inv * sb (1 + s when kPlusOne) for the
// vectors a thread holds, rounded to x's type and stored.
template <typename T, int kVecs, bool kWide, bool kPlusOne>
__device__ __forceinline__ void write_rows(const Pack<T> (&xs)[kVecs],
                                           const Pack<T> (&ps)[kVecs],
                                           const Pack<T> (&qs)[kVecs], float inv,
                                           T* ya, T* yb, int t, int row_threads,
                                           int nv, int D) {
  constexpr int N = Pack<T>::n;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = k * row_threads + t;
    if (v >= nv) continue;
    Pack<T> oa, ob;
#pragma unroll
    for (int j = 0; j < N; j += 2) {
      float sa[2], sb[2], xn[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        xn[i] = __fmul_rn(to_float(xs[k].v[j + i]), inv);
        sa[i] = to_float(ps[k].v[j + i]);
        sb[i] = to_float(qs[k].v[j + i]);
        if (kPlusOne) {
          sa[i] = __fadd_rn(1.f, sa[i]);
          sb[i] = __fadd_rn(1.f, sb[i]);
        }
      }
      put2(oa, j, __fmul_rn(xn[0], sa[0]), __fmul_rn(xn[1], sa[1]));
      put2(ob, j, __fmul_rn(xn[0], sb[0]), __fmul_rn(xn[1], sb[1]));
    }
    store_pack<T, kWide>(ya, v, D, oa);
    store_pack<T, kWide>(yb, v, D, ob);
  }
}

template <typename T, int kVecs, bool kWide>
__global__ void __launch_bounds__(kMaxWarps * 32)
    dual_rmsnorm_kernel(NormArgs a) {
  constexpr int N = Pack<T>::n;
  __shared__ float part[kMaxWarps];   // one sum per warp of the row
  const int row_threads = a.warps * 32;
  const int t = threadIdx.x;
  const long long row = blockIdx.x;
  const int nv = (a.D + N - 1) / N;
  const T* sa = static_cast<const T*>(a.sa);
  const T* sb = static_cast<const T*>(a.sb);
  const T* x = static_cast<const T*>(a.x) + row * a.x_stride;
  T* ya = static_cast<T*>(a.y) + row * a.D;
  T* yb = ya + static_cast<long long>(a.M) * a.D;

  const float rcp_d = __frcp_rn(static_cast<float>(a.D));   // off the chain
  allow_next_grid();       // the next grid waits for this one's completion
  wait_for_prior_grid();

  Pack<T> ps[kVecs], qs[kVecs], xs[kVecs];
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = k * row_threads + t;
    if (v < nv) {
      ps[k] = load_pack<T, kWide, false>(sa, v, a.D);
      qs[k] = load_pack<T, kWide, false>(sb, v, a.D);
    }
  }
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int v = k * row_threads + t;
    if (v < nv) xs[k] = load_pack<T, kWide, true>(x, v, a.D);
  }

  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    if (k * row_threads + t < nv) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const float f = to_float(xs[k].v[j]);
        ss = __fmaf_rn(f, f, ss);
      }
    }
  }
  ss = warp_sum(ss);
  if (a.warps > 1) {   // uniform over the block: every thread reaches the barrier
    if ((t & 31) == 0) part[t >> 5] = ss;
    __syncthreads();
    float p[kMaxWarps];
#pragma unroll
    for (int w = 0; w < kMaxWarps; ++w) p[w] = w < a.warps ? part[w] : 0.f;
    ss = p[0];   // then in warp order, all reads issued first
#pragma unroll
    for (int w = 1; w < kMaxWarps; ++w)
      if (w < a.warps) ss = __fadd_rn(ss, p[w]);
  }
  const float inv = rsqrtf(__fadd_rn(__fmul_rn(ss, rcp_d), a.eps));
  if (a.plus_one)
    write_rows<T, kVecs, kWide, true>(xs, ps, qs, inv, ya, yb, t, row_threads, nv, a.D);
  else
    write_rows<T, kVecs, kWide, false>(xs, ps, qs, inv, ya, yb, t, row_threads, nv, a.D);
}

__global__ void noop_kernel() {}

// The empty kernel launched as the dual RMSNorm is: it waits for the
// kernel before it, and nothing else.
__global__ void noop_wait_kernel() { wait_for_prior_grid(); }

// Launches `kernel` on `grid` x `block` threads with programmatic stream
// serialization when `pdl`.
template <typename... Args>
int launch_ex(void (*kernel)(Args...), unsigned grid, unsigned block, bool pdl,
              cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One block a row, with programmatic dependent launch.
template <typename T, int kVecs>
int launch(const NormArgs& a, bool wide, cudaStream_t s) {
  const unsigned grid = static_cast<unsigned>(a.M), block = a.warps * 32;
  return wide ? launch_ex(dual_rmsnorm_kernel<T, kVecs, true>, grid, block, true, s, a)
              : launch_ex(dual_rmsnorm_kernel<T, kVecs, false>, grid, block, true, s, a);
}

// The vectors a thread holds, rounded up to the instantiated 1, 2, 4 or 8.
template <typename T>
int dispatch(const NormArgs& a, int vecs, bool wide, cudaStream_t s) {
  if (vecs <= 1) return launch<T, 1>(a, wide, s);
  if (vecs <= 2) return launch<T, 2>(a, wide, s);
  if (vecs <= 4) return launch<T, 4>(a, wide, s);
  return launch<T, kMaxVecs>(a, wide, s);
}

}  // namespace

// x: [M, D] rows x_stride elements apart, unit stride within a row; sa, sb:
// [D] contiguous; y: contiguous [2, M, D]; all of the type `dtype` names.
// `warps` must be the row layout's (min(8, ceil(ceil(D / n) / 32)), n = 16
// bytes of elements): the caller states it so that the layout it tested is
// the one launched. `wide`: 16-byte loads and stores (the caller checked
// D % n == 0 and the alignment of every row and scale). Returns 0 on
// success, a cudaError_t code after a failed launch, or -1 for arguments
// the kernel does not take.
extern "C" int repro_dual_rmsnorm(const void* x, const void* sa, const void* sb,
                                  void* y, int dtype, int M, int D,
                                  long long x_stride, float eps, int plus_one,
                                  int warps, int wide, void* stream) {
  const int n = dtype == kFloat32 ? 4 : 8;
  const int nv = (D + n - 1) / n;
  if (M <= 0 || D <= 0 || D > kMaxD || warps != std::min(kMaxWarps, (nv + 31) / 32))
    return -1;
  const int vecs = (nv + 32 * warps - 1) / (32 * warps);
  const NormArgs a{x, sa, sb, y, x_stride, M, D, warps, eps, plus_one};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch<float>(a, vecs, wide != 0, s);
  if (dtype == kBFloat16) return dispatch<__nv_bfloat16>(a, vecs, wide != 0, s);
  return -1;
}

// One block of 32 threads that does nothing: the launch floor that every
// small kernel's time is read against. With `pdl`, launched as the dual
// RMSNorm is (programmatic dependent launch, waiting on the kernel before):
// the floor of such a launch.
extern "C" int repro_noop(int pdl, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pdl ? launch_ex(noop_wait_kernel, 1, 32, true, s)
             : launch_ex(noop_kernel, 1, 32, false, s);
}
