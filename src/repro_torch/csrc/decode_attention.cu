// Decode attention: one query token per row against the KV cache, single
// layer or both halves of an LP pair in one launch, over a contiguous ring
// cache or the continuous-batching engine's paged pool.
//
// Replaces: the JAX package's kernels/decode_attention.py, `_kernel` /
// `_launch` behind `decode_attention` and `decode_attention_pair` (ring),
// and `_paged_kernel` / `_launch_paged` behind `decode_attention_paged` and
// `decode_attention_pair_paged` (paged). Each body below serves all four:
// it is templated only on how a logical key position maps to an address.
//   ring:  pos * stride                  (cache [P, B, L, Hkv, hd])
//   paged: bt[b][pos / ps] * page_stride + (pos % ps) * stride
//                                        (pool [P, n_pages, ps, Hkv, hd])
// The paged form reads each row's horizon t[b] and its block table from
// device memory (no host scalar), and both halves of a pair use the same
// block table at their own half of the pool.
//
// What bounds it on the card: bytes in principle. Each row reads its cache
// keys and values once (positions 0..t) and does 4*g*hd flops per key,
// about 4 flops per byte in bf16 at g = 8, far below the ~295 the H100
// needs to be compute bound. At the main path's shapes, though, the cache
// is under 1 MB (a fraction of a microsecond at 3.35 TB/s), and what
// bounds the kernel is latency: the chain of dependent steps one block
// walks for its row. With one block per (half, batch, kv head) row, as
// this kernel first was, the grid held 16 to 64 blocks on 132 SMs and each
// walked all of its row's key tiles in turn.
//
// What the design does about it:
//  * Split keys across a thread-block cluster. Keys are cut into fixed
//    chunks of 64 positions. kSplit = 4 blocks per row launch as one
//    cluster (cudaLaunchKernelEx with a cluster dimension); block j walks
//    chunks j, j + 4, j + 8, ... below min(L, t + 1) with its own online
//    softmax, so the grid has 4x the rows' blocks and a row's chain is a
//    quarter as long. A block with no chunk contributes m = kNegInf, l = 0
//    and acc = 0.
//  * Combine in distributed shared memory, in the same launch. Each block
//    writes its (m, l, acc[g x hd]) into its own slot in rank 0's shared
//    memory and arrives at the cluster barrier (release); rank 0 waits
//    (acquire) and combines the slots in the fixed order j = 0..3:
//    M = max m_j, l = sum l_j e^(m_j - M), acc = sum acc_j e^(m_j - M).
//    The term of a block with no keys is exactly 0. Every block arrives
//    once more at its start and waits before its remote writes, so no
//    block writes into a peer that has not started; peers exit after
//    writing, since nobody reads their shared memory. One launch per call:
//    a separate combine kernel would add a launch to a host-bound decode
//    step.
//  * Loads: 16-byte cp.async copies (8 bf16 or 4 fp32) into shared memory.
//    Rows past t are zero-filled, never read. A block's first chunk is
//    requested before t[b] arrives (the page lookups do not depend on it).
//    Staged rows are padded by 16 bytes, so the 8 rows that a warp's
//    16-byte reads or an ldmatrix touch fall in distinct banks.
//  * The g query heads of a kv head share the staged chunk: each cache
//    byte is read from device memory once per GQA group. The cache is read
//    in its stored layout through strides (hd contiguous; pointers and row
//    strides multiples of 16 bytes, checked by the host wrapper): no
//    transpose or gather copy per step.
//
// Two bodies, chosen by type and group width (never by B, L or t):
//  * bf16 with g <= 16 (every path of this repo): one warp per block on the
//    tensor cores, as the flash kernel. The g heads are the 16 rows of an
//    mma (zero-padded), held as A fragments straight from device memory;
//    S = Q K^T (ldmatrix on K), the online softmax over each 64-key chunk
//    in fp32 registers (log2 domain), P rounded to bf16 and O += P V
//    (ldmatrix.trans on V) in fp32 registers. Per chunk 32 mma for S and
//    32 for P V at hd = 64, where the CUDA-core body spends most of its
//    time converting bf16 and chaining multiply-adds. A second chunk
//    buffer, with the next chunk in flight, only where L > 4 chunks.
//  * fp32, and bf16 with g > 16: 256 threads on the CUDA cores (fp32 on
//    tensor cores would be TF32; fp32 is the type of the parity runs),
//    the next chunk in flight while this one is reduced. Scores and the
//    online softmax one warp per query head, each lane two keys, each dot
//    product as 8 (bf16) or 4 (fp32) partial sums over hd added pairwise;
//    p V one thread per (key part, head, 8 columns of hd) with as many key
//    parts as the 256 threads allow, the parts added in a fixed order
//    after the last chunk.
//
// Batch invariance: a row's reduction depends only on its own t[b]. Chunk
// boundaries are fixed positions, which block walks which chunk depends on
// the chunk index alone, the key parts on g and hd alone, and the combine
// order is fixed. Nothing depends on B, on L or n_pg * ps (keys past t are
// never visited; L sets only how many chunk buffers the tensor-core body
// keeps), or on other rows. So a row gives the same bits alone,
// among 8 slots or among the speculative verifier's n_slots * (k + 1)
// rows; a paginated copy of a ring cache gives the ring kernel's output
// bit for bit; and the engine's decode equals generate's. Idle engine rows
// (t = 0 on the reserved page 0) read one zero key.
//
// Block tables are trusted: the engine validates every running row against
// its owned pages on the host before the launch.
#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

using namespace repro;
namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;   // keys per chunk
constexpr int kSplit = 4;    // blocks per row, one cluster
constexpr int kAcc = 8;      // output columns per p V task
constexpr int kMaxParts = 16;
constexpr int kStages = 2;   // chunk buffers: one reduced, one in flight

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
  int stages;       // bf16 tensor-core body: chunk buffers (1 or 2)
};

inline int pitch(int hd, int elem) { return hd + 16 / elem; }  // +16 bytes

inline size_t smem_bytes(int G, int hd, int elem) {
  return size_t(kStages) * 2 * kChunk * pitch(hd, elem) * elem +
         sizeof(float) * (size_t(G) * hd + size_t(G) * kChunk + 3 * size_t(G) +
                          kSplit * (2 * size_t(G) + size_t(G) * hd));
}

__device__ __forceinline__ void load16(float (&f)[8], const __nv_bfloat16* p) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(h2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void load16(float (&f)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// kAcc = 8 consecutive elements, 16-byte aligned.
__device__ __forceinline__ void load8(float (&f)[8], const __nv_bfloat16* p) {
  load16(f, p);
}

__device__ __forceinline__ void load8(float (&f)[8], const float* p) {
  float lo[4], hi[4];
  load16(lo, p);
  load16(hi, p + 4);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = lo[i];
    f[4 + i] = hi[i];
  }
}

// The cluster barrier with arrive and wait apart (PTX): a block arrives
// early and waits late, or arrives and exits.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// fp32, and bf16 with g > 16: CUDA cores, 256 threads per block
// ---------------------------------------------------------------------------

template <typename T, int HD, bool kPaged>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kSeg = HD / kVec;       // copies per key row
  constexpr int kPitch = HD + kVec;     // staged row, padded by 16 bytes
  constexpr int kLaneKeys = kChunk / 32;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int G = a.G;
  const int part_stride = 2 * G + G * HD;  // one block's (m[G], l[G], acc[G][HD])
  T* kv_s = reinterpret_cast<T*>(decode_smem);  // [stage][K, V][kChunk][kPitch]
  float* q_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kChunk * kPitch);  // [G][HD]
  float* p_s = q_s + G * HD;      // [G][kChunk] this chunk's p
  float* m_s = p_s + G * kChunk;  // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* c_s = l_s + G;           // [G] this chunk's correction
  float* part_s = c_s + G;        // [kSplit][part_stride], filled on rank 0
  float* red_s = reinterpret_cast<float*>(decode_smem);  // key parts, over kv_s at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // this block has started: peers may write to it later
  const int row = blockIdx.x / kSplit;
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
  const int* bt = kPaged ? a.bt + static_cast<long long>(b) * a.n_pg : nullptr;
  const int t = kPaged ? a.tv[b] : a.t;
  const int n_keys = min(a.L, t + 1);
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  auto load_chunk = [&](int c, int stage) {
    T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    T* v_st = k_st + kChunk * kPitch;
    for (int i = tid; i < kChunk * kSeg; i += kThreads) {
      const int j = i / kSeg, seg = i % kSeg, pos = c * kChunk + j;
      long long ko = 0, vo = 0;
      if (pos < a.L) {  // a valid block-table index, whatever t is
        if constexpr (kPaged) {
          const long long page = bt[pos / a.ps];
          ko = page * a.ks[1] + (pos % a.ps) * a.ks[2];
          vo = page * a.vs[1] + (pos % a.ps) * a.vs[2];
        } else {
          ko = pos * a.ks[2];
          vo = pos * a.vs[2];
        }
      }
      const int bytes = pos < n_keys ? 16 : 0;
      cp_async16(k_st + j * kPitch + seg * kVec, k + ko + seg * kVec, bytes);
      cp_async16(v_st + j * kPitch + seg * kVec, v + vo + seg * kVec, bytes);
    }
  };
  // The first chunk's page lookups do not wait for t[b]: both loads fly at
  // once. A block whose chunk lies past t copies nothing (zero fill).
  if (rank * kChunk < a.L) load_chunk(rank, 0);
  cp_async_commit();

  for (int e = tid; e < G * HD; e += kThreads)
    q_s[e] = to_float(q[(e / HD) * a.qs[3] + e % HD]);
  for (int gi = tid; gi < G; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.f;
  }

  // p V tasks: (key part, head, kAcc columns). The number of parts depends
  // on g and hd only.
  const int n_cols = G * HD / kAcc;
  int parts = 1;
  while (parts < kMaxParts && 2 * parts * n_cols <= kThreads) parts *= 2;
  const int part_len = kChunk / parts;
  const bool has_task = tid < parts * n_cols;
  const int col = tid % n_cols, part = tid / n_cols;
  const int gi_t = col / (HD / kAcc), d0 = (col % (HD / kAcc)) * kAcc;
  float acc[kAcc];
#pragma unroll
  for (int u = 0; u < kAcc; ++u) acc[u] = 0.f;

  int stage = 0;
  for (int c = rank; c < n_chunks; c += kSplit, stage ^= 1) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c is in; the previous chunk's readers are done
    if (c + kSplit < n_chunks) load_chunk(c + kSplit, stage ^ 1);
    cp_async_commit();
    const T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    const T* v_st = k_st + kChunk * kPitch;

    // Scores and the online softmax, one warp per query head; lane l owns
    // keys l and l + 32. Each dot product is kVec partial sums over hd,
    // added pairwise at the end.
    for (int gi = warp; gi < G; gi += kWarps) {
      const float* qr = q_s + gi * HD;
      float d[kLaneKeys][kVec];
#pragma unroll
      for (int i = 0; i < kLaneKeys; ++i)
#pragma unroll
        for (int u = 0; u < kVec; ++u) d[i][u] = 0.f;
#pragma unroll
      for (int seg = 0; seg < kSeg; ++seg) {
        float qf[kVec];
#pragma unroll
        for (int u = 0; u < kVec; u += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qr + seg * kVec + u);
          qf[u] = q4.x;
          qf[u + 1] = q4.y;
          qf[u + 2] = q4.z;
          qf[u + 3] = q4.w;
        }
#pragma unroll
        for (int i = 0; i < kLaneKeys; ++i) {
          float kf[kVec];
          load16(kf, k_st + (lane + 32 * i) * kPitch + seg * kVec);
#pragma unroll
          for (int u = 0; u < kVec; ++u) d[i][u] += qf[u] * kf[u];
        }
      }
      float sc[kLaneKeys], mx = kNegInf;
#pragma unroll
      for (int i = 0; i < kLaneKeys; ++i) {
#pragma unroll
        for (int w = kVec / 2; w > 0; w /= 2)
#pragma unroll
          for (int u = 0; u < w; ++u) d[i][u] += d[i][u + w];
        sc[i] = c * kChunk + lane + 32 * i < n_keys ? d[i][0] * a.scale : kNegInf;
        mx = fmaxf(mx, sc[i]);
      }
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kLaneKeys; ++i) {
        const float pj = expf(sc[i] - m_new);
        p_s[gi * kChunk + lane + 32 * i] = pj;
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
    if (has_task) {
      const float* prow = p_s + gi_t * kChunk + part * part_len;
      const T* vcol = v_st + part * part_len * kPitch + d0;
      float pv[kAcc];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) pv[u] = 0.f;
#pragma unroll 4
      for (int j = 0; j < part_len; ++j) {
        float vf[kAcc];
        load8(vf, vcol + j * kPitch);
        const float pj = prow[j];
#pragma unroll
        for (int u = 0; u < kAcc; ++u) pv[u] += pj * vf[u];
      }
      const float corr = c_s[gi_t];
#pragma unroll
      for (int u = 0; u < kAcc; ++u) acc[u] = acc[u] * corr + pv[u];
    }
  }

  // This block's (m, l, acc) into its slot on rank 0; the key parts are
  // added in order 0..parts-1.
  cp_async_wait<0>();  // a block past t still has its zero fill in flight
  __syncthreads();     // the last chunk's readers are done with kv_s
  if (has_task) {
#pragma unroll
    for (int u = 0; u < kAcc; ++u) red_s[part * G * HD + gi_t * HD + d0 + u] = acc[u];
  }
  __syncthreads();
  cluster_wait();  // every block of the cluster has started
  float* slot = cluster.map_shared_rank(part_s, 0) + rank * part_stride;
  for (int e = tid; e < G * HD; e += kThreads) {
    float s = red_s[e];
    for (int kp = 1; kp < parts; ++kp) s += red_s[kp * G * HD + e];
    slot[2 * G + e] = s;
  }
  for (int gi = tid; gi < G; gi += kThreads) {
    slot[gi] = m_s[gi];
    slot[G + gi] = l_s[gi];
  }
  cluster_arrive_release();  // the slot is written; peers may now exit
  if (rank != 0) return;

  // Rank 0: combine the kSplit blocks in the fixed order j = 0..kSplit-1.
  cluster_wait();
  T* o = static_cast<T*>(a.o) + p * a.os[0] + b * a.os[1] + h * a.os[2];
  for (int e = tid; e < G * HD; e += kThreads) {
    const int gi = e / HD;
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) M = fmaxf(M, part_s[j * part_stride + gi]);
    float l = 0.f, sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const float* pj = part_s + j * part_stride;
      const float w = expf(pj[gi] - M);
      l += pj[G + gi] * w;
      sum += pj[2 * G + e] * w;
    }
    o[gi * a.os[3] + e % HD] = from_float<T>(sum / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// bfloat16, g <= 16: tensor cores, one warp per block
// ---------------------------------------------------------------------------

constexpr int kMmaHeads = 16;  // the m rows of one mma: the g heads, zero-padded

inline size_t mma_smem_bytes(int G, int hd, int stages) {
  return size_t(stages) * 2 * kChunk * (hd + 8) * sizeof(__nv_bfloat16) +
         sizeof(float) * (kSplit * (2 * size_t(G) + size_t(G) * hd) +
                          (kSplit + 1) * kMmaHeads);
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<unsigned*>(&v);
}

template <int HD, bool kPaged>
__global__ void __launch_bounds__(32) decode_mma_kernel(DecodeArgs a) {
  using T = __nv_bfloat16;
  constexpr int kPitch = HD + 8;   // staged row, padded by 16 bytes
  constexpr int kSeg = HD / 8;     // 16-byte copies per key row
  constexpr int kKSteps = HD / 16; // mma k steps over hd in S = Q K^T
  constexpr int kNT = kChunk / 8;  // 8-key column tiles of S
  constexpr int kDT = HD / 8;      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const int G = a.G;
  const int part_stride = 2 * G + G * HD;  // one block's (m[G], l[G], acc[G][HD])
  T* kv_s = reinterpret_cast<T*>(decode_smem);  // [stage][K, V][kChunk][kPitch]
  float* part_s = reinterpret_cast<float*>(kv_s + a.stages * 2 * kChunk * kPitch);
  float* w_s = part_s + kSplit * part_stride;  // rank 0: [kSplit + 1][kMmaHeads]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // this block has started: peers may write to it later
  const int row = blockIdx.x / kSplit;
  const int h = row % a.H;
  const int b = (row / a.H) % a.B;
  const int p = row / (a.H * a.B);
  const T* q = static_cast<const T*>(a.q) + p * a.qs[0] + b * a.qs[1] + h * a.qs[2];
  const T* k = static_cast<const T*>(a.k) + p * a.ks[0] + h * a.ks[3] +
               (kPaged ? 0 : b * a.ks[1]);
  const T* v = static_cast<const T*>(a.v) + p * a.vs[0] + h * a.vs[3] +
               (kPaged ? 0 : b * a.vs[1]);
  const int* bt = kPaged ? a.bt + static_cast<long long>(b) * a.n_pg : nullptr;
  const int t = kPaged ? a.tv[b] : a.t;
  const int n_keys = min(a.L, t + 1);
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  const int lane = threadIdx.x, g = lane / 4, t4 = lane % 4;

  // Each lane copies kIters 16-byte pieces of K and of V per chunk. The
  // paged form reads all their pages first, so the block-table loads are in
  // flight together (a page size that is a power of two divides by shifts).
  constexpr int kIters = kChunk * kSeg / 32;
  const bool ps_pow2 = kPaged && (a.ps & (a.ps - 1)) == 0;
  const int ps_log2 = __ffs(a.ps) - 1;
  auto load_chunk = [&](int c, int stage) {
    T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    T* v_st = k_st + kChunk * kPitch;
    int page[kIters], in_page[kIters];
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const int pos = c * kChunk + (lane + 32 * r) / kSeg;
      page[r] = 0;
      in_page[r] = pos < a.L ? pos : 0;  // source addresses stay in the cache
      if constexpr (kPaged) {
        const int pg = ps_pow2 ? pos >> ps_log2 : pos / a.ps;
        in_page[r] = pos - pg * a.ps;
        if (pos < a.L) page[r] = bt[pg];  // a valid index, whatever t is
      }
    }
#pragma unroll
    for (int r = 0; r < kIters; ++r) {
      const int i = lane + 32 * r, j = i / kSeg, seg = i % kSeg;
      const long long ko = page[r] * a.ks[1] + in_page[r] * a.ks[2];
      const long long vo = page[r] * a.vs[1] + in_page[r] * a.vs[2];
      const int bytes = c * kChunk + j < n_keys ? 16 : 0;
      cp_async16(k_st + j * kPitch + seg * 8, k + ko + seg * 8, bytes);
      cp_async16(v_st + j * kPitch + seg * 8, v + vo + seg * 8, bytes);
    }
  };
  if (rank * kChunk < a.L) load_chunk(rank, 0);
  cp_async_commit();

  // Q as mma A fragments, straight from device memory: rows g and g + 8 are
  // heads g and g + 8 (zeros past G).
  unsigned qf[kKSteps][4];
  const T zero = __float2bfloat16(0.f);
#pragma unroll
  for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int gi = g + 8 * (r & 1), d = ks * 16 + 8 * (r >> 1) + 2 * t4;
      const T* qr = q + gi * a.qs[3] + d;
      qf[ks][r] = gi < G ? pack2(qr[0], qr[1]) : pack2(zero, zero);
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // heads g, g + 8
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  int it = 0;
  for (int c = rank; c < n_chunks; c += kSplit, ++it) {
    const int stage = it % a.stages;
    const bool more = c + kSplit < n_chunks;
    cp_async_wait<0>();
    __syncwarp();  // chunk c is in; every lane is done with the other buffer
    if (more && a.stages > 1) load_chunk(c + kSplit, stage ^ 1);
    cp_async_commit();
    const T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    const T* v_st = k_st + kChunk * kPitch;

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      if constexpr (kKSteps % 2 == 0) {
#pragma unroll
        for (int ks = 0; ks < kKSteps; ks += 2) {
          unsigned kf[4];  // k steps ks and ks + 1 of keys nt*8..nt*8+7
          ldsm_x4(kf, k_st + (nt * 8 + lane % 8) * kPitch + ks * 16 + (lane / 8) * 8);
          mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
          mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
        }
      } else {  // hd = 16: one k step
        unsigned kf[2];
        ldsm_x2(kf, k_st + (nt * 8 + lane % 8) * kPitch + ((lane / 8) % 2) * 8);
        mma_bf16(s[nt], qf[0], kf[0], kf[1]);
      }
    }

    // Keys past t masked, then the online softmax over the chunk (log2
    // domain), row max across the quad of lanes that share a head.
    const int kbase = c * kChunk + 2 * t4;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = kbase + nt * 8 + (e & 1) < n_keys ? s[nt][e] * scale_log2 : kNegInf;
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int d = 0; d < kDT; ++d) {
      o[d][0] *= c0;
      o[d][1] *= c0;
      o[d][2] *= c1;
      o[d][3] *= c1;
    }
    // O += P V, 16 keys per k step.
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int d = 0; d < kDT; d += 2) {
        unsigned vf[4];
        ldsm_x4_trans(vf, v_st + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kPitch +
                              d * 8 + (lane / 16) * 8);
        mma_bf16(o[d], pa, vf[0], vf[1]);
        mma_bf16(o[d + 1], pa, vf[2], vf[3]);
      }
    }
    if (more && a.stages == 1) {
      __syncwarp();  // every lane is done with the one buffer
      load_chunk(c + kSplit, 0);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();  // a block past t still has its zero fill in flight
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  // This block's (m, l, acc) into its slot on rank 0.
  cluster_wait();  // every block of the cluster has started
  float* slot = cluster.map_shared_rank(part_s, 0) + rank * part_stride;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int gi = g + 8 * half;
    if (gi >= G) continue;
    if (t4 == 0) {
      slot[gi] = half ? m1 : m0;
      slot[G + gi] = half ? l1 : l0;
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<float2*>(slot + 2 * G + gi * HD + d * 8 + 2 * t4) =
          make_float2(o[d][2 * half], o[d][2 * half + 1]);
  }
  cluster_arrive_release();  // the slot is written; peers may now exit
  if (rank != 0) return;

  // Rank 0: combine the kSplit blocks in the fixed order j = 0..kSplit-1.
  cluster_wait();
  if (lane < G) {
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) M = fmaxf(M, part_s[j * part_stride + lane]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const float w = exp2f(part_s[j * part_stride + lane] - M);
      l += part_s[j * part_stride + G + lane] * w;
      w_s[j * kMmaHeads + lane] = w;
    }
    w_s[kSplit * kMmaHeads + lane] = 1.f / fmaxf(l, 1e-30f);
  }
  __syncwarp();
  T* o_g = static_cast<T*>(a.o) + p * a.os[0] + b * a.os[1] + h * a.os[2];
  for (int e = lane; e < G * HD; e += 32) {
    const int gi = e / HD;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j)
      sum += part_s[j * part_stride + 2 * G + e] * w_s[j * kMmaHeads + gi];
    o_g[gi * a.os[3] + e % HD] = __float2bfloat16(sum * w_s[kSplit * kMmaHeads + gi]);
  }
}

// One launch of `kernel` with kSplit blocks per row as one cluster.
template <typename Kernel>
int launch_cluster(Kernel kernel, const DecodeArgs& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P * a.B * a.H * kSplit);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD, bool kPaged>
int launch(DecodeArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (a.G <= kMmaHeads) {
      // A second chunk buffer only where a block walks more than one chunk.
      a.stages = a.L > kSplit * kChunk ? 2 : 1;
      return launch_cluster(decode_mma_kernel<HD, kPaged>, a, 32,
                            mma_smem_bytes(a.G, HD, a.stages), stream);
    }
  }
  return launch_cluster(decode_kernel<T, HD, kPaged>, a, kThreads,
                        smem_bytes(a.G, HD, sizeof(T)), stream);
}

template <typename T, bool kPaged>
int dispatch_hd(DecodeArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, kPaged>(a, stream);
    case 32: return launch<T, 32, kPaged>(a, stream);
    case 64: return launch<T, 64, kPaged>(a, stream);
    case 128: return launch<T, 128, kPaged>(a, stream);
    default: return -1;
  }
}

// The 16-byte copies need the cache's pointers and row strides (over half,
// batch or page, position and head) in multiples of 16 bytes.
bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
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
  const int elem = dtype == kFloat32 ? 4 : 2;
  if (!aligned16(a.k) || !aligned16(a.v)) return -1;
  for (int i = 0; i < 4; ++i)
    if ((a.ks[i] * elem) % 16 != 0 || (a.vs[i] * elem) % 16 != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) return dispatch_hd<float, kPaged>(a, hd, s);
  if (dtype == kBFloat16) return dispatch_hd<__nv_bfloat16, kPaged>(a, hd, s);
  return -1;
}

bool bad_shape(int G, int hd, int L, int dtype) {
  const int elem = dtype == kFloat32 ? 4 : 2;
  return G * hd > kThreads * kAcc || hd <= 0 || G <= 0 || L <= 0 ||
         smem_bytes(G, hd, elem) > 227 * 1024 ||
         mma_smem_bytes(G, hd, 2) > 227 * 1024;
}

}  // namespace

// Returns 0 on success, a cudaError_t code after a failed launch (a refused
// cluster launch included), or -1 for arguments the kernel does not take
// (the Python wrapper checks first).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int P, int B, int H, int G, int L,
                                      int hd, const long long* strides, int t,
                                      float scale, void* stream) {
  if (bad_shape(G, hd, L, dtype) || t < 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, L, {}, {}, {}, {},
               t, nullptr, nullptr, 0, 0, scale, 1};
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
  if (bad_shape(G, hd, n_pg * ps, dtype) || ps <= 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, n_pg * ps, {}, {}, {}, {},
               0, bt, tv, n_pg, ps, scale, 1};
  return dispatch<true>(a, dtype, hd, strides, stream);
}
