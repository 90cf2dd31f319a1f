// Decode attention: one query token per row against the KV cache, single
// layer or both halves of an LP pair in one launch, over a contiguous ring
// cache or the continuous-batching engine's paged pool.
//
// Replaces: the JAX package's kernels/decode_attention.py, `_kernel` /
// `_launch` behind `decode_attention` and `decode_attention_pair` (ring),
// and `_paged_kernel` / `_launch_paged` behind `decode_attention_paged` and
// `decode_attention_pair_paged` (paged). One body serves all four: it is
// templated only on how a logical key position maps to an address.
//   ring:  pos * stride                  (cache [P, B, L, Hkv, hd])
//   paged: bt[b][pos / ps] * page_stride + (pos % ps) * stride
//                                        (pool [P, n_pages, ps, Hkv, hd])
// Both read keys in 64-wide tiles in logical-position order with the same
// online softmax, so a paginated copy of a ring cache gives the ring
// kernel's output bit for bit. The paged form reads each row's horizon
// t[b] and its block table from device memory (no host scalar), and both
// halves of a pair use the same block table at their own half of the pool.
//
// What bounds it on the card: bytes. Each row reads its cache keys and
// values once (positions 0..t) and does 4*g*hd flops per key, about 4 flops
// per byte in bf16 at g = 8, far below the ~295 the H100 needs to be
// compute bound.
//
// What the design does about it:
//  * One block per (half, batch, kv head) row. The g query heads of that kv
//    head sit in shared memory, so each cache tile is read from device
//    memory once for the whole GQA group.
//  * The cache is read in its stored layout through strides: no transpose
//    or gather copy per step. Only hd must be contiguous. The paged form
//    looks each key's page up once per tile (a 64-entry offset table in
//    shared memory), not once per loaded element.
//  * Keys past t are masked, so their tiles are exact no-ops of the online
//    softmax; the loop stops at min(L, t + 1) and never reads them. The
//    ragged edge of the last tile is masked in-kernel (no padding of L).
//  * Online softmax in fp32 over tiles of 64 keys; m, l and the per-tile
//    correction live in shared memory, the accumulator in registers.
//  * hd is a template parameter (16/32/64/128) so the dot-product loops
//    unroll, and 8 warps share the work: with one block per SM these loops
//    are bound by shared-memory latency, not by bandwidth.
//
// Known limit: the grid is only 2*B*Hkv rows (64 blocks at B = 8, Hkv = 4)
// on 132 SMs. Splitting L across blocks is later work, and it must keep
// each row's reduction independent of B. Block tables are trusted: the
// engine validates every running row against its owned pages on the host
// before the launch; idle rows point at the reserved page 0 with t = 0.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileL = 64;
constexpr int kAccPerThread = 8;   // g * hd <= kThreads * kAccPerThread
constexpr int kBatch = 8;          // cache loads in flight per thread

struct DecodeArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int P, B, H, G, L;
  // element strides: q/o over (half, batch, head, group); k/v over
  // (half, batch, position, head). The last dim (hd) is contiguous.
  // Paged pool: k/v strides are over (half, page, position in page, head)
  // and L = n_pg * ps.
  long long qs[4], ks[4], vs[4], os[4];
  int t;            // ring: the horizon shared by every row
  const int* bt;    // paged: block tables [B, n_pg], device memory
  const int* tv;    // paged: per-row horizons [B], device memory
  int n_pg, ps;
  float scale;
};

// Paged form: a table of the tile's key offsets (k and v) sits ahead of
// the float arrays in shared memory, measured here in floats.
constexpr int kPagedTable = 2 * kTileL * sizeof(long long) / sizeof(float);

inline size_t smem_bytes(int G, int hd, bool paged) {
  return sizeof(float) *
         ((paged ? kPagedTable : 0) + size_t(G) * hd + size_t(kTileL) * (hd + 1) +
          size_t(kTileL) * hd + size_t(G) * kTileL + 3 * size_t(G));
}

template <typename T, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int G = a.G;
  constexpr int kpitch = HD + 1;  // odd pitch: rows of K land in distinct banks
  // Paged: this tile's key offsets along the pool's (page, position) axes,
  // one block-table lookup per key, so the loads below divide nothing.
  long long* koff_s = reinterpret_cast<long long*>(smem);   // [kTileL]
  long long* voff_s = koff_s + kTileL;                      // [kTileL]
  float* q_s = smem + (kPaged ? kPagedTable : 0);  // [G][HD]
  float* k_s = q_s + G * HD;              // [kTileL][HD + 1]
  float* v_s = k_s + kTileL * kpitch;     // [kTileL][HD]
  float* s_s = v_s + kTileL * HD;         // [G][kTileL] scores, then p
  float* m_s = s_s + G * kTileL;          // [G] running max
  float* l_s = m_s + G;                   // [G] running sum
  float* c_s = l_s + G;                   // [G] this tile's correction

  const int row = blockIdx.x;
  const int h = row % a.H;
  const int b = (row / a.H) % a.B;
  const int p = row / (a.H * a.B);
  const T* q = static_cast<const T*>(a.q) + p * a.qs[0] + b * a.qs[1] + h * a.qs[2];
  // Ring: the row's cache starts at its batch index; paged: the block
  // table picks a page per position.
  const T* k = static_cast<const T*>(a.k) + p * a.ks[0] + h * a.ks[3] +
               (kPaged ? 0 : b * a.ks[1]);
  const T* v = static_cast<const T*>(a.v) + p * a.vs[0] + h * a.vs[3] +
               (kPaged ? 0 : b * a.vs[1]);
  T* o = static_cast<T*>(a.o) + p * a.os[0] + b * a.os[1] + h * a.os[2];
  const int* bt = kPaged ? a.bt + static_cast<long long>(b) * a.n_pg : nullptr;
  const int t = kPaged ? a.tv[b] : a.t;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < G * HD; e += kThreads)
    q_s[e] = to_float(q[(e / HD) * a.qs[3] + e % HD]);
  for (int gi = tid; gi < G; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.f;
  }
  float acc[kAccPerThread];
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  const int n_keys = min(a.L, t + 1);
  for (int base = 0; base < n_keys; base += kTileL) {
    __syncthreads();  // the previous tile's readers are done
    if constexpr (kPaged) {
      if (tid < kTileL) {
        const int pos = base + tid;
        const long long page = pos < n_keys ? bt[pos / a.ps] : 0;
        koff_s[tid] = page * a.ks[1] + (pos % a.ps) * a.ks[2];
        voff_s[tid] = page * a.vs[1] + (pos % a.ps) * a.vs[2];
      }
      __syncthreads();
    }
    // kBatch loads per thread in flight before the first store.
    for (int e0 = tid; e0 < kTileL * HD; e0 += kThreads * kBatch) {
      float kv[kBatch], vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, pos = base + e / HD, d = e % HD;
        const bool in = e < kTileL * HD && pos < n_keys;
        if constexpr (kPaged) {
          kv[u] = in ? to_float(k[koff_s[e / HD] + d]) : 0.f;
          vv[u] = in ? to_float(v[voff_s[e / HD] + d]) : 0.f;
        } else {
          kv[u] = in ? to_float(k[pos * a.ks[2] + d]) : 0.f;
          vv[u] = in ? to_float(v[pos * a.vs[2] + d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < kTileL * HD) {
          k_s[(e / HD) * kpitch + e % HD] = kv[u];
          v_s[e] = vv[u];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < G * kTileL; e += kThreads) {
      const int gi = e / kTileL, j = e % kTileL;
      float s = kNegInf;
      if (base + j < n_keys) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) dot += q_s[gi * HD + d] * k_s[j * kpitch + d];
        s = dot * a.scale;
      }
      s_s[e] = s;
    }
    __syncthreads();
    for (int gi = warp; gi < G; gi += kWarps) {  // one warp per query head
      float* srow = s_s + gi * kTileL;
      float mx = kNegInf;
      for (int j = lane; j < kTileL; j += 32) mx = fmaxf(mx, srow[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTileL; j += 32) {
        const float pj = expf(srow[j] - m_new);
        srow[j] = pj;
        sum += pj;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kAccPerThread; ++i) {
      const int e = tid + i * kThreads;
      if (e < G * HD) {
        const int gi = e / HD, d = e % HD;
        const float* prow = s_s + gi * kTileL;
        float pv = 0.f;
#pragma unroll 16
        for (int j = 0; j < kTileL; ++j) pv += prow[j] * v_s[j * HD + d];
        acc[i] = acc[i] * c_s[gi] + pv;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kAccPerThread; ++i) {
    const int e = tid + i * kThreads;
    if (e < G * HD) {
      const int gi = e / HD, d = e % HD;
      o[gi * a.os[3] + d] = from_float<T>(acc[i] / fmaxf(l_s[gi], 1e-30f));
    }
  }
}

template <typename T, int HD, bool kPaged>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.G, HD, kPaged);
  cudaError_t err = allow_smem(decode_kernel<T, HD, kPaged>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_kernel<T, HD, kPaged><<<a.P * a.B * a.H, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kPaged>
int dispatch_hd(const DecodeArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, kPaged>(a, stream);
    case 32: return launch<T, 32, kPaged>(a, stream);
    case 64: return launch<T, 64, kPaged>(a, stream);
    case 128: return launch<T, 128, kPaged>(a, stream);
    default: return -1;
  }
}

template <bool kPaged>
int dispatch(DecodeArgs& a, int dtype, int hd, const long long* strides,
             void* stream) {
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[4 + i];
    a.vs[i] = strides[8 + i];
    a.os[i] = strides[12 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float, kPaged>(a, hd, s);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16, kPaged>(a, hd, s);
  return -1;
}

bool bad_shape(int G, int hd, int L, bool paged) {
  return G * hd > kThreads * kAccPerThread || hd <= 0 || G <= 0 || L <= 0 ||
         smem_bytes(G, hd, paged) > 227 * 1024;
}

}  // namespace

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// arguments the kernel does not take (the Python wrapper checks first).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int P, int B, int H, int G, int L,
                                      int hd, const long long* strides, int t,
                                      float scale, void* stream) {
  if (bad_shape(G, hd, L, false) || t < 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, L, {}, {}, {}, {},
               t, nullptr, nullptr, 0, 0, scale};
  return dispatch<false>(a, dtype, hd, strides, stream);
}

// Paged form: k/v are the pool [P, n_pages, ps, H, hd] through strides;
// bt [B, n_pg] and tv [B] are int32 in device memory. Same return codes.
extern "C" int repro_decode_attention_paged(const void* q, const void* k,
                                            const void* v, void* o,
                                            const int* bt, const int* tv,
                                            int dtype, int P, int B, int H,
                                            int G, int n_pg, int ps, int hd,
                                            const long long* strides,
                                            float scale, void* stream) {
  if (bad_shape(G, hd, n_pg * ps, true) || ps <= 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, n_pg * ps, {}, {}, {}, {},
               0, bt, tv, n_pg, ps, scale};
  return dispatch<true>(a, dtype, hd, strides, stream);
}
