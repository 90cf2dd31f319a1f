// Flash attention for prefill: tiled attention with an online fp32 softmax,
// GQA-folded query rows, and the JAX package's five mask kinds.
//
// Replaces: the JAX package's kernels/flash_attention.py, `flash_attention`
// (its `_kernel` behind the one pallas_call).
//
// What bounds it on the card: at the prefill shapes of the main path
// (S = 128, hd = 64, causal) the work is small, ~2*hd flops per allowed
// (query, key) pair twice, and the kernel is bound by how much of the card
// it keeps busy rather than by bytes or by tensor-core flops. This first
// version does the products in fp32 on the CUDA cores; wgmma and TMA are
// later work.
//
// What the design does about it:
//  * Grid over (batch x kv head, tiles of 32 folded query rows). Query rows
//    are GQA-folded as in the JAX kernel (row = position * g + head), so a
//    kv tile in shared memory serves the g query heads of its kv head.
//  * Four threads per query row, each owning every fourth element of hd:
//    the dot product is reduced with two warp shuffles and the shared-memory
//    reads of one key row fall in distinct banks.
//  * The kv tile width `block_n` is fixed by the caller and never clamped to
//    T. With a pinned width, a row's reduction grouping depends only on its
//    own key horizon: a fully masked tile is an exact no-op (finite
//    kNegInf, corr = 1, p = 0) and a partly masked one reduces over the same
//    lanes whatever the padded length. That keeps right-padding of the key
//    axis bit-transparent, as the "chunked:<kb>" attention core does.
//  * Tiles that every row of the block masks are skipped (keys above the
//    causal horizon, below a window or chunk start). Skipping them is exact:
//    a tile after the first allowed key is a no-op, and one before it is
//    wiped by corr = exp(kNegInf - m) = 0.
//  * Inputs are read in their stored layout through strides: q and the
//    output as [B, S, H, g, hd], k and v as [B, T, H, hd]. No transposes.
//  * The query offset q0 is one int for the launch, or one per batch row
//    read from device memory (the engine's bucketed prefill, where each
//    radix-hit row starts at its own context length). Each block uses its
//    row's q0 for both the mask and the tile-skip range, so fully masked
//    tiles stay exact no-ops per row, and equal per-row offsets give the
//    scalar launch's output bit for bit.
//
// A query row that may attend to no key at all (no mask of this repo makes
// one: the diagonal is always allowed) gets zeros, or the mean of the values
// in the tiles its block visited, where the plain version averages all T.
#include "common.cuh"

using namespace repro;

namespace {

constexpr int kRows = 32;          // folded query rows per block
constexpr int kThreadsPerRow = 4;  // threads sharing one query row
constexpr int kThreads = kRows * kThreadsPerRow;
constexpr int kBatch = 8;          // kv loads in flight per thread

// mask kinds, shared with the Python wrapper
constexpr int kCausal = 0;
constexpr int kWindow = 1;
constexpr int kChunk = 2;
constexpr int kBidir = 3;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, S, G, T;
  // element strides: q/o over (batch, position, head, group); k/v over
  // (batch, position, head). The last dim (hd) is contiguous.
  long long qs[4], ks[3], vs[3], os[4];
  int kind, window, chunk, prefix_len, q0, k0, block_n;
  const int* q0_rows;  // per-row query offsets [B] in device memory, or null
  float scale;
};

inline size_t smem_bytes(int block_n, int hd) {
  return sizeof(float) * (2 * size_t(block_n) * hd + size_t(kRows) * block_n);
}

__device__ __forceinline__ bool allowed(const FlashArgs& a, int qpos,
                                        int kpos) {
  if (a.kind == kBidir) return true;
  const bool causal = kpos <= qpos;
  if (a.kind == kCausal) return causal || (a.prefix_len > 0 && kpos < a.prefix_len);
  if (a.kind == kWindow) return causal && (qpos - kpos < a.window);
  return causal && (qpos / a.chunk == kpos / a.chunk);  // kChunk
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(FlashArgs a) {
  constexpr int DPT = HD / kThreadsPerRow;  // hd elements per thread
  extern __shared__ float smem[];
  const int BN = a.block_n;
  float* k_s = smem;            // [BN][HD]
  float* v_s = k_s + BN * HD;   // [BN][HD]
  float* s_s = v_s + BN * HD;   // [kRows][BN]

  const int bh = blockIdx.x;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = a.q0_rows ? a.q0_rows[b] : a.q0;
  const int n_rows = a.S * a.G;
  const int tid = threadIdx.x;
  const int rloc = tid / kThreadsPerRow, part = tid % kThreadsPerRow;
  const int r = blockIdx.y * kRows + rloc;
  const bool row_ok = r < n_rows;
  const int qpos = q0 + (row_ok ? r : n_rows - 1) / a.G;

  const T* kb = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vb = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];

  float qr[DPT], acc[DPT];
  if (row_ok) {
    const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] +
                  (r / a.G) * a.qs[1] + h * a.qs[2] + (r % a.G) * a.qs[3];
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = to_float(qp[i * kThreadsPerRow + part]);
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  // Key range any row of this block may attend to, as absolute positions.
  const int row_lo = blockIdx.y * kRows;
  const int row_hi = min(n_rows, row_lo + kRows) - 1;
  const int qmin = q0 + row_lo / a.G, qmax = q0 + row_hi / a.G;
  const int k_limit = a.k0 + a.T;
  int lo = a.k0, hi = k_limit;
  if (a.kind != kBidir) {
    hi = min(hi, max(qmax + 1, a.kind == kCausal ? a.prefix_len : 0));
    if (a.kind == kWindow) lo = max(lo, qmin - a.window + 1);
    if (a.kind == kChunk) lo = max(lo, (qmin / a.chunk) * a.chunk);
  }
  const int t_begin = lo > a.k0 ? (lo - a.k0) / BN : 0;
  const int t_end = hi > a.k0 ? (hi - a.k0 + BN - 1) / BN : 0;

  for (int kt = t_begin; kt < t_end; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    // kBatch loads per thread in flight before the first store.
    for (int e0 = tid; e0 < BN * HD; e0 += kThreads * kBatch) {
      float kv[kBatch], vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, kl = kt * BN + e / HD, d = e % HD;
        const bool in = e < BN * HD && kl < a.T;  // ragged edge: finite zeros
        kv[u] = in ? to_float(kb[kl * a.ks[1] + d]) : 0.f;
        vv[u] = in ? to_float(vb[kl * a.vs[1] + d]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads;
        if (e < BN * HD) {
          k_s[e] = kv[u];
          v_s[e] = vv[u];
        }
      }
    }
    __syncthreads();

    float* srow = s_s + rloc * BN;
    float mx = kNegInf;
    for (int j = 0; j < BN; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) dot += qr[i] * k_s[j * HD + i * kThreadsPerRow + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = a.k0 + kt * BN + j;
      const bool ok = row_ok && kpos < k_limit && allowed(a, qpos, kpos);
      const float s = ok ? dot * a.scale : kNegInf;
      if (part == 0) srow[j] = s;
      mx = fmaxf(mx, s);
    }
    __syncwarp();
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float lsum = 0.f, pv[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) pv[i] = 0.f;
    for (int j = 0; j < BN; ++j) {
      const float p = expf(srow[j] - m_new);
      lsum += p;
#pragma unroll
      for (int i = 0; i < DPT; ++i) pv[i] += p * v_s[j * HD + i * kThreadsPerRow + part];
    }
    l = l * corr + lsum;
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = acc[i] * corr + pv[i];
    m = m_new;
  }

  if (row_ok) {
    T* op = static_cast<T*>(a.o) + b * a.os[0] + (r / a.G) * a.os[1] +
            h * a.os[2] + (r % a.G) * a.os[3];
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      op[i * kThreadsPerRow + part] = from_float<T>(acc[i] / l_safe);
  }
}

template <typename T, int HD>
int launch(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.block_n, HD);
  cudaError_t err = allow_smem(flash_kernel<T, HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S * a.G + kRows - 1) / kRows);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const FlashArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(a, stream);
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return -1;
  }
}

}  // namespace

// Returns 0 on success, a cudaError_t code after a failed launch, or -1 for
// arguments the kernel does not take (the Python wrapper checks first).
// q0_rows: null for the scalar q0, else int32 [B] in device memory.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int H, int S, int G, int T, int hd,
                                     const long long* strides, int kind,
                                     int window, int chunk, int prefix_len,
                                     int q0, const int* q0_rows, int k0,
                                     int block_n, float scale, void* stream) {
  if (block_n <= 0 || smem_bytes(block_n, hd) > 227 * 1024 || kind < 0 ||
      kind > kBidir || (kind == kWindow && window <= 0) ||
      (kind == kChunk && chunk <= 0) || S <= 0 || T <= 0 || G <= 0)
    return -1;
  FlashArgs a{q, k, v, o, B, H, S, G, T, {}, {}, {}, {},
              kind, window, chunk, prefix_len, q0, k0, block_n, q0_rows, scale};
  for (int i = 0; i < 4; ++i) {
    a.qs[i] = strides[i];
    a.os[i] = strides[10 + i];
  }
  for (int i = 0; i < 3; ++i) {
    a.ks[i] = strides[4 + i];
    a.vs[i] = strides[7 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float>(a, hd, s);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16>(a, hd, s);
  return -1;
}
