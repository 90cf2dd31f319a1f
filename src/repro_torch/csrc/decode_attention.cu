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
// block table at their own half of the pool. It may also take a head map
// hm [Hkv] in device memory (the JAX kernel's third scalar-prefetch
// operand): q's kv head h then reads the pool's stored head hm[h], and the
// pool may hold more stored heads than q has kv heads. A tensor-parallel
// rank over replicated kv heads selects its head(s) this way, with no
// per-rank copy of the pool; both halves of a pair share the map.
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
// Two bodies, chosen by type (never by B, L or t):
//  * bf16: the tensor cores, as the flash kernel. Each 16 query heads of
//    the group (zero-padded past g) are the 16 rows of an mma: a head
//    group, ceil(g / 16) of them per block; all warps stage each 64-key
//    chunk together, so the cache is still read once per GQA group. Per
//    head group: S = Q K^T (ldmatrix on K), the online softmax over the
//    chunk in fp32 registers (log2 domain), P rounded to bf16 and O += P V
//    (ldmatrix.trans on V) in fp32 registers; per chunk 32 mma for S and 32
//    for P V at hd = 64, where CUDA cores would spend most of their time
//    converting bf16 and chaining multiply-adds. A head's arithmetic is its
//    head group's alone, so it does not depend on how many the block has.
//    A second chunk buffer, with the next chunk in flight, only where L > 4
//    chunks. One head group at g <= 16 (every path but granite-34b's MQA,
//    g = 48: three) is its own instantiation: with the warp count a
//    constant, its copy rounds unroll without bounds tests (one template
//    for both ran 4-6% slower at g <= 16 on an H100).
//    Up to hd = 64 a head group is one warp, holding Q as A fragments
//    straight from device memory. From hd = 128 it is two column warps
//    (col_warps): one warp would hold 64 (hd 128) or 128 (hd 256) registers
//    of O beside 32 or 64 of Q fragments. Each column warp computes the
//    whole S for the 16 heads (the same instructions on the same data, so
//    both hold the same bits of S, m and l) and owns half of O's columns;
//    Q is staged in shared memory and read by ldmatrix per k step; each
//    lane looks up the pages of two keys of the chunk and a copy round
//    takes its keys' pages by a shuffle, where the one-warp bodies keep a
//    page and an offset per round in registers. At hd = 128 the one-warp
//    body this replaced spilled 376-908 bytes a thread (ptxas) and was 24%
//    slower at yi-6b's shape on an H100; the two-warp bodies spill nothing.
//  * fp32: 256 threads on the CUDA cores (fp32 on tensor cores would be
//    TF32; fp32 is the type of the parity runs), the next chunk in flight
//    while this one is reduced where two chunk buffers fit in shared
//    memory (one buffer otherwise: g * hd = 6144 at granite's shape).
//    Scores and the online softmax one warp per query head, each lane two
//    keys, each dot product as 4 partial sums over hd added pairwise; p V
//    as (key part, head, 8 columns of hd) tasks, up to kMaxTasks a thread,
//    with as many key parts as the 256 threads allow, the parts added in a
//    fixed order after the last chunk. One task a thread (g * hd <= 2048)
//    is its own instantiation: the 4-task one holds 4x the accumulators
//    and ran up to 1.43x slower there on an H100.
// A block takes at most the heads its shared memory holds (the slots of
// the combine grow with g * hd; bf16 also at most 8 warps): wider groups
// are cut into equal head slices, each its own cluster, each reading the
// cache once (at hd = 256 a slice may hold 16 heads or fewer: it runs the
// wide body). So any g is taken; at this repo's shapes every group fits
// one slice.
//
// Batch invariance: a row's reduction depends only on its own t[b]. Chunk
// boundaries are fixed positions, which block walks which chunk depends on
// the chunk index alone, the head slices, buffers and key parts on g and hd
// alone, and the combine order is fixed. Nothing depends on B, on L or
// n_pg * ps (keys past t are never visited; L sets only how many chunk
// buffers the tensor-core body keeps), or on other rows. So a row gives the
// same bits alone, among 8 slots or among the speculative verifier's
// n_slots * (k + 1) rows; a paginated copy of a ring cache gives the ring
// kernel's output bit for bit; and the engine's decode equals generate's.
// Idle engine rows (t = 0 on the reserved page 0) read one zero key.
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
constexpr int kMaxTasks = 4;  // p V tasks per thread: g * hd <= 8192 per block
constexpr int kMaxMmaWarps = 8;  // tensor-core body: warps a block at most
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMmaHeads = 16;  // the m rows of one mma: 16 heads, zero-padded

// Warps that share one 16-head mma row block, each owning HD / col_warps
// columns of O: two from hd = 128, where one warp's O and Q fragments
// would not fit its registers; one below.
__host__ __device__ constexpr int col_warps(int hd) { return hd >= 128 ? 2 : 1; }

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
  const int* hm;    // paged: q's kv head h reads stored head hm[h] [H]; nullptr: h
  int n_pg, ps;
  float scale;
  int stages;       // chunk buffers (1 or 2)
  int GB;           // heads per block: the group is cut into n_slices slices
  int n_slices;
};

// A cluster's row: half p, batch b, kv head h, and its heads h0..h0+G-1.
struct RowOf {
  int p, b, h, h0, G;
};

// The row, head slice and heads of this block's cluster. kSliced false: a
// body that never cuts its group (one head slice, g = G).
template <bool kSliced>
__device__ __forceinline__ RowOf row_of(const DecodeArgs& a) {
  const int row = blockIdx.x / kSplit;
  const int slice = kSliced ? row % a.n_slices : 0;
  const int r = kSliced ? row / a.n_slices : row;
  RowOf x;
  x.h = r % a.H;
  x.b = (r / a.H) % a.B;
  x.p = r / (a.H * a.B);
  x.h0 = slice * a.GB;
  x.G = kSliced ? min(a.GB, a.G - x.h0) : a.G;
  return x;
}

inline int pitch(int hd, int elem) { return hd + 16 / elem; }  // +16 bytes

inline size_t smem_bytes(int G, int hd, int elem, int stages) {
  return size_t(stages) * 2 * kChunk * pitch(hd, elem) * elem +
         sizeof(float) * (size_t(G) * hd + size_t(G) * kChunk + 3 * size_t(G) +
                          kSplit * (2 * size_t(G) + size_t(G) * hd));
}

__device__ __forceinline__ void load16(float (&f)[4], const float* p) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x;
  f[1] = u.y;
  f[2] = u.z;
  f[3] = u.w;
}

// kAcc = 8 consecutive elements, 16-byte aligned.
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
// fp32: CUDA cores, 256 threads per block
// ---------------------------------------------------------------------------

// kTasks: p V tasks per thread, 1 where g * hd <= kThreads * kAcc.
template <int HD, bool kPaged, int kTasks>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecodeArgs a) {
  using T = float;
  constexpr int kVec = 16 / sizeof(T);  // elements per 16-byte copy
  constexpr int kSeg = HD / kVec;       // copies per key row
  constexpr int kPitch = HD + kVec;     // staged row, padded by 16 bytes
  constexpr int kLaneKeys = kChunk / 32;
  extern __shared__ __align__(16) unsigned char decode_smem[];
  // kTasks == 1: g * hd fits one block, which holds two chunk buffers.
  const RowOf r = row_of<(kTasks > 1)>(a);
  const int G = r.G;
  const int stages = kTasks > 1 ? a.stages : 2;
  const int part_stride = 2 * G + G * HD;  // one block's (m[G], l[G], acc[G][HD])
  T* kv_s = reinterpret_cast<T*>(decode_smem);  // [stage][K, V][kChunk][kPitch]
  float* q_s = reinterpret_cast<float*>(kv_s + stages * 2 * kChunk * kPitch);  // [G][HD]
  float* p_s = q_s + G * HD;      // [G][kChunk] this chunk's p
  float* m_s = p_s + G * kChunk;  // [G] running max
  float* l_s = m_s + G;           // [G] running sum
  float* c_s = l_s + G;           // [G] this chunk's correction
  float* part_s = c_s + G;        // [kSplit][part_stride], filled on rank 0
  float* red_s = reinterpret_cast<float*>(decode_smem);  // key parts, over kv_s and q_s at the end

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // this block has started: peers may write to it later
  const int p = r.p, b = r.b, h = r.h;
  const T* q = static_cast<const T*>(a.q) + p * a.qs[0] + b * a.qs[1] + h * a.qs[2] +
               r.h0 * a.qs[3];
  // Ring: the row's cache starts at its batch index; paged: the block
  // table picks a page per position, and the head map (where one is given)
  // the pool's stored head.
  const int hs = kPaged && a.hm != nullptr ? a.hm[h] : h;
  const T* k = static_cast<const T*>(a.k) + p * a.ks[0] + hs * a.ks[3] +
               (kPaged ? 0 : b * a.ks[1]);
  const T* v = static_cast<const T*>(a.v) + p * a.vs[0] + hs * a.vs[3] +
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
    q_s[e] = q[(e / HD) * a.qs[3] + e % HD];
  for (int gi = tid; gi < G; gi += kThreads) {
    m_s[gi] = kNegInf;
    l_s[gi] = 0.f;
  }

  // p V tasks: (key part, head, kAcc columns), task tid + i * kThreads for
  // i < kTasks. The number of parts depends on g and hd only.
  const int n_cols = G * HD / kAcc;
  int parts = 1;
  while (parts < kMaxParts && 2 * parts * n_cols <= kThreads) parts *= 2;
  const int part_len = kChunk / parts;
  const int n_tasks = parts * n_cols;
  bool has_task[kTasks];
  int part_of[kTasks], gi_of[kTasks], d0_of[kTasks];
  float acc[kTasks][kAcc];
#pragma unroll
  for (int i = 0; i < kTasks; ++i) {
    const int task = tid + i * kThreads, col = task % n_cols;
    has_task[i] = task < n_tasks;
    part_of[i] = task / n_cols;
    gi_of[i] = col / (HD / kAcc);
    d0_of[i] = (col % (HD / kAcc)) * kAcc;
#pragma unroll
    for (int u = 0; u < kAcc; ++u) acc[i][u] = 0.f;
  }

  int it = 0;
  for (int c = rank; c < n_chunks; c += kSplit, ++it) {
    const int stage = it % stages;
    const bool more = c + kSplit < n_chunks;
    cp_async_wait<0>();
    __syncthreads();  // chunk c is in; the previous chunk's readers are done
    if (more && stages > 1) load_chunk(c + kSplit, stage ^ 1);
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
        load16(qf, qr + seg * kVec);
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
#pragma unroll
    for (int i = 0; i < kTasks; ++i) {
      if (!has_task[i]) continue;
      const int part = part_of[i], gi_t = gi_of[i], d0 = d0_of[i];
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
      for (int u = 0; u < kAcc; ++u) acc[i][u] = acc[i][u] * corr + pv[u];
    }
    if (more && stages == 1) {
      __syncthreads();  // every thread is done with the one buffer
      load_chunk(c + kSplit, 0);
      cp_async_commit();
    }
  }

  // This block's (m, l, acc) into its slot on rank 0; the key parts are
  // added in order 0..parts-1. red_s spans parts * G * HD floats: within
  // kv_s and q_s, which no thread reads any more.
  cp_async_wait<0>();  // a block past t still has its zero fill in flight
  __syncthreads();     // the last chunk's readers are done with kv_s
#pragma unroll
  for (int i = 0; i < kTasks; ++i) {
    if (!has_task[i]) continue;
#pragma unroll
    for (int u = 0; u < kAcc; ++u)
      red_s[part_of[i] * G * HD + gi_of[i] * HD + d0_of[i] + u] = acc[i][u];
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
  T* o = static_cast<T*>(a.o) + p * a.os[0] + b * a.os[1] + h * a.os[2] + r.h0 * a.os[3];
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
    o[gi * a.os[3] + e % HD] = sum / fmaxf(l, 1e-30f);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores, one warp per 16 heads
// ---------------------------------------------------------------------------

// Chunk buffers, the combine's slots and weights, and (two column warps)
// the staged Q rows.
inline size_t mma_smem_bytes(int G, int hd, int stages) {
  const size_t rows = (G + kMmaHeads - 1) / kMmaHeads * kMmaHeads;  // 16 * head groups
  return size_t(stages) * 2 * kChunk * (hd + 8) * sizeof(__nv_bfloat16) +
         sizeof(float) * (kSplit * (2 * size_t(G) + size_t(G) * hd) + (kSplit + 1) * rows) +
         (col_warps(hd) > 1 ? rows * (hd + 8) * sizeof(__nv_bfloat16) : 0);
}

__device__ __forceinline__ unsigned pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<unsigned*>(&v);
}

// kWide: more than 16 heads, ceil(g / 16) >= 2 head groups of col_warps
// warps each; otherwise one head group, known at compile time.
template <int HD, bool kPaged, bool kWide>
__global__ void __launch_bounds__(kWide ? 32 * kMaxMmaWarps : 32 * col_warps(HD))
    decode_mma_kernel(DecodeArgs a) {
  using T = __nv_bfloat16;
  constexpr int kCW = col_warps(HD);
  constexpr bool kMulti = kWide || kCW > 1;  // more than one warp
  constexpr int kPitch = HD + 8;   // staged row, padded by 16 bytes
  constexpr int kSeg = HD / 8;     // 16-byte copies per key row
  constexpr int kKSteps = HD / 16; // mma k steps over hd in S = Q K^T
  constexpr int kNT = kChunk / 8;  // 8-key column tiles of S
  constexpr int kDT = HD / 8 / kCW;  // 8-wide column tiles of O in this warp
  extern __shared__ __align__(16) unsigned char decode_smem[];
  const RowOf r = row_of<kWide>(a);  // one head group: g <= 16, never sliced
  const int G = r.G;
  const int part_stride = 2 * G + G * HD;  // one block's (m[G], l[G], acc[G][HD])
  T* kv_s = reinterpret_cast<T*>(decode_smem);  // [stage][K, V][kChunk][kPitch]
  float* part_s = reinterpret_cast<float*>(kv_s + a.stages * 2 * kChunk * kPitch);
  float* w_s = part_s + kSplit * part_stride;  // rank 0: [kSplit + 1][16 * head groups]

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  cluster_arrive_relaxed();  // this block has started: peers may write to it later
  const int p = r.p, b = r.b, h = r.h;
  const T* q = static_cast<const T*>(a.q) + p * a.qs[0] + b * a.qs[1] + h * a.qs[2] +
               r.h0 * a.qs[3];
  // The pool's stored head: through the head map where one is given.
  const int hs = kPaged && a.hm != nullptr ? a.hm[h] : h;
  const T* k = static_cast<const T*>(a.k) + p * a.ks[0] + hs * a.ks[3] +
               (kPaged ? 0 : b * a.ks[1]);
  const T* v = static_cast<const T*>(a.v) + p * a.vs[0] + hs * a.vs[3] +
               (kPaged ? 0 : b * a.vs[1]);
  const int* bt = kPaged ? a.bt + static_cast<long long>(b) * a.n_pg : nullptr;
  const int t = kPaged ? a.tv[b] : a.t;
  const int n_keys = min(a.L, t + 1);
  const int n_chunks = (n_keys + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int nthreads = kWide ? blockDim.x : 32 * kCW, nwarps = nthreads / 32;
  const int warp = kMulti ? tid / 32 : 0, lane = tid % 32;
  const int hw = warp / kCW, cw = warp % kCW;  // head group, column part
  const int g = lane / 4, t4 = lane % 4;
  T* q_s = reinterpret_cast<T*>(w_s + (kSplit + 1) * kMmaHeads * (nwarps / kCW));
  auto block_sync = [] {
    if constexpr (kMulti) __syncthreads(); else __syncwarp();
  };

  // A chunk is kIters rounds of 32 16-byte copies of K and of V; warp w
  // takes rounds w, w + nwarps, ... (at most kRounds: the wide body has at
  // least two warps, two column warps when a sliced group holds one head
  // group). The paged form reads all its pages first, so the block-table
  // loads are in flight together (a page size that is a power of two
  // divides by shifts).
  constexpr int kIters = kChunk * kSeg / 32;
  constexpr int kRounds = kWide && kCW == 1 ? (kIters + 1) / 2 : kIters / kCW;
  const bool ps_pow2 = kPaged && (a.ps & (a.ps - 1)) == 0;
  const int ps_log2 = __ffs(a.ps) - 1;
  auto load_chunk = [&](int c, int stage) {
    T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    T* v_st = k_st + kChunk * kPitch;
    if constexpr (kCW > 1) {
      // Round rd copies keys rd * kKeys .. of the chunk (two at hd = 128,
      // one at 256), all in one half of it. Lane l looks up the pages of
      // keys l and l + 32; a lane takes its key's page by a shuffle.
      constexpr int kKeys = 32 / kSeg;
      const unsigned ul = threadIdx.x & 31u;  // lane, known to be in [0, 32)
      int pg_lo = 0, pg_hi = 0;
      if constexpr (kPaged) {
        const int p0 = c * kChunk + lane, p1 = p0 + 32;
        if (p0 < a.L) pg_lo = bt[ps_pow2 ? p0 >> ps_log2 : p0 / a.ps];
        if (p1 < a.L) pg_hi = bt[ps_pow2 ? p1 >> ps_log2 : p1 / a.ps];
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int rd = warp + u * nwarps;
        if (rd >= kIters) break;
        const int j = rd * kKeys + static_cast<int>(ul / kSeg);
        const int seg = static_cast<int>(ul % kSeg);
        const int pos = c * kChunk + j;
        long long page = 0;
        int in_page = pos < a.L ? pos : 0;  // source addresses stay in the cache
        if constexpr (kPaged) {
          const int pg = __shfl_sync(0xffffffffu, j < 32 ? pg_lo : pg_hi, j % 32);
          page = pos < a.L ? pg : 0;
          in_page = ps_pow2 ? pos & (a.ps - 1) : pos % a.ps;
        }
        const long long ko = page * a.ks[1] + in_page * a.ks[2];
        const long long vo = page * a.vs[1] + in_page * a.vs[2];
        const int bytes = pos < n_keys ? 16 : 0;
        cp_async16(k_st + j * kPitch + seg * 8, k + ko + seg * 8, bytes);
        cp_async16(v_st + j * kPitch + seg * 8, v + vo + seg * 8, bytes);
      }
    } else {
      int page[kRounds], in_page[kRounds];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int rd = warp + u * nwarps;
        const int pos = c * kChunk + (lane + 32 * rd) / kSeg;
        page[u] = 0;
        in_page[u] = pos < a.L ? pos : 0;  // source addresses stay in the cache
        if constexpr (kPaged) {
          const int pg = ps_pow2 ? pos >> ps_log2 : pos / a.ps;
          in_page[u] = pos - pg * a.ps;
          if (rd < kIters && pos < a.L) page[u] = bt[pg];  // a valid index, whatever t is
        }
      }
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int rd = warp + u * nwarps;
        if (rd >= kIters) break;
        const int i = lane + 32 * rd, j = i / kSeg, seg = i % kSeg;
        const int pos = c * kChunk + j;
        const long long ko = page[u] * a.ks[1] + in_page[u] * a.ks[2];
        const long long vo = page[u] * a.vs[1] + in_page[u] * a.vs[2];
        const int bytes = pos < n_keys ? 16 : 0;
        cp_async16(k_st + j * kPitch + seg * 8, k + ko + seg * 8, bytes);
        cp_async16(v_st + j * kPitch + seg * 8, v + vo + seg * 8, bytes);
      }
    }
  };
  if (rank * kChunk < a.L) load_chunk(rank, 0);
  cp_async_commit();

  // One warp a head group: its 16 heads as mma A fragments, straight from
  // device memory: rows g and g + 8 are heads 16w + g and 16w + g + 8 (zeros
  // past G). Two column warps: the block's heads staged in q_s instead
  // (zeros past G), read by ldmatrix at each k step; the first chunk's sync
  // publishes them.
  const int head0 = hw * kMmaHeads;
  const T zero = __float2bfloat16(0.f);
  unsigned qf[kCW > 1 ? 1 : kKSteps][4];
  if constexpr (kCW > 1) {
    for (int e = tid; e < (nwarps / kCW) * kMmaHeads * HD; e += nthreads) {
      const int gi = e / HD, d = e % HD;
      q_s[gi * kPitch + d] = gi < G ? q[gi * a.qs[3] + d] : zero;
    }
  } else {
#pragma unroll
    for (int ks = 0; ks < kKSteps; ++ks) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        const int gi = head0 + g + 8 * (rr & 1), d = ks * 16 + 8 * (rr >> 1) + 2 * t4;
        const T* qr = q + gi * a.qs[3] + d;
        qf[ks][rr] = gi < G ? pack2(qr[0], qr[1]) : pack2(zero, zero);
      }
    }
  }

  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)

  int it = 0;
  for (int c = rank; c < n_chunks; c += kSplit, ++it) {
    const int stage = it % a.stages;
    const bool more = c + kSplit < n_chunks;
    cp_async_wait<0>();
    block_sync();  // chunk c is in; every thread is done with the other buffer
    if (more && a.stages > 1) load_chunk(c + kSplit, stage ^ 1);
    cp_async_commit();
    const T* k_st = kv_s + stage * 2 * kChunk * kPitch;
    const T* v_st = k_st + kChunk * kPitch;

    float s[kNT][4];
    if constexpr (kCW > 1) {
      // Q from shared memory: k steps outer, so each key tile's sum still
      // runs over k steps 0, 1, ... in order.
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKSteps; ks += 2) {
        unsigned qa[4], qb[4];
        const T* qrow = q_s + (head0 + lane % 16) * kPitch + (lane / 16) * 8;
        ldsm_x4(qa, qrow + ks * 16);
        ldsm_x4(qb, qrow + (ks + 1) * 16);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          unsigned kf[4];  // k steps ks and ks + 1 of keys nt*8..nt*8+7
          ldsm_x4(kf, k_st + (nt * 8 + lane % 8) * kPitch + ks * 16 + (lane / 8) * 8);
          mma_bf16(s[nt], qa, kf[0], kf[1]);
          mma_bf16(s[nt], qb, kf[2], kf[3]);
        }
      }
    } else {
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
    // O += P V, 16 keys per k step, over this warp's columns of O.
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
                              (cw * kDT + d) * 8 + (lane / 16) * 8);
        mma_bf16(o[d], pa, vf[0], vf[1]);
        mma_bf16(o[d + 1], pa, vf[2], vf[3]);
      }
    }
    if (more && a.stages == 1) {
      block_sync();  // every thread is done with the one buffer
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
    const int gi = head0 + g + 8 * half;
    if (gi >= G) continue;
    if (t4 == 0 && cw == 0) {  // column warps hold the same m and l
      slot[gi] = half ? m1 : m0;
      slot[G + gi] = half ? l1 : l0;
    }
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<float2*>(slot + 2 * G + gi * HD + (cw * kDT + d) * 8 + 2 * t4) =
          make_float2(o[d][2 * half], o[d][2 * half + 1]);
  }
  cluster_arrive_release();  // the slot is written; peers may now exit
  if (rank != 0) return;

  // Rank 0: combine the kSplit blocks in the fixed order j = 0..kSplit-1.
  // One thread per head (G <= 16 * head groups < threads) writes its
  // kSplit weights and 1 / l; rows of 16 * head groups heads, a constant
  // for one head group.
  cluster_wait();
  const int ws = kMmaHeads * (nwarps / kCW);
  if (tid < G) {
    float M = kNegInf;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) M = fmaxf(M, part_s[j * part_stride + tid]);
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j) {
      const float w = exp2f(part_s[j * part_stride + tid] - M);
      l += part_s[j * part_stride + G + tid] * w;
      w_s[j * ws + tid] = w;
    }
    w_s[kSplit * ws + tid] = 1.f / fmaxf(l, 1e-30f);
  }
  block_sync();
  T* o_g = static_cast<T*>(a.o) + p * a.os[0] + b * a.os[1] + h * a.os[2] + r.h0 * a.os[3];
  for (int e = tid; e < G * HD; e += nthreads) {
    const int gi = e / HD;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kSplit; ++j)
      sum += part_s[j * part_stride + 2 * G + e] * w_s[j * ws + gi];
    o_g[gi * a.os[3] + e % HD] = __float2bfloat16(sum * w_s[kSplit * ws + gi]);
  }
}

// One launch of `kernel` with kSplit blocks per (row, head slice) as one
// cluster.
template <typename Kernel>
int launch_cluster(Kernel kernel, const DecodeArgs& a, int threads, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.P * a.B * a.H * a.n_slices * kSplit);
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

// Heads per block: the most that fit (shared memory; the tensor-core body
// also kMaxMmaWarps warps, the CUDA-core body kMaxTasks p V tasks a
// thread), then the group cut into equal slices. A function of g, hd and
// the type alone.
void slice_heads(DecodeArgs& a, bool mma, int hd) {
  int cap = mma ? min(a.G, kMaxMmaWarps / col_warps(hd) * kMmaHeads)
                : min(a.G, kThreads * kAcc * kMaxTasks / hd);
  while (cap > 1 && (mma ? mma_smem_bytes(cap, hd, 2)
                         : smem_bytes(cap, hd, sizeof(float), 1)) > kMaxSmem)
    --cap;
  a.n_slices = (a.G + cap - 1) / cap;
  a.GB = (a.G + a.n_slices - 1) / a.n_slices;
}

template <typename T, int HD, bool kPaged>
int launch(DecodeArgs& a, cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    slice_heads(a, true, HD);
    // A second chunk buffer only where a block walks more than one chunk.
    a.stages = a.L > kSplit * kChunk ? 2 : 1;
    constexpr int kCW = col_warps(HD);
    const int groups = (a.GB + kMmaHeads - 1) / kMmaHeads;
    const size_t smem = mma_smem_bytes(a.GB, HD, a.stages);
    // The wide body: more than one head group, or a group cut into slices
    // (at hd = 256 a slice may hold 16 heads or fewer).
    if (groups > 1 || a.n_slices > 1)
      return launch_cluster(decode_mma_kernel<HD, kPaged, true>, a, 32 * kCW * groups,
                            smem, stream);
    return launch_cluster(decode_mma_kernel<HD, kPaged, false>, a, 32 * kCW, smem,
                          stream);
  } else {
    slice_heads(a, false, HD);
    a.stages = smem_bytes(a.GB, HD, sizeof(float), 2) <= kMaxSmem ? 2 : 1;
    const size_t smem = smem_bytes(a.GB, HD, sizeof(float), a.stages);
    // One task a thread: one head slice with two buffers (always so where
    // g * hd <= kThreads * kAcc, since a block holds more than that).
    if (a.GB * HD <= kThreads * kAcc && a.n_slices == 1 && a.stages == 2)
      return launch_cluster(decode_kernel<HD, kPaged, 1>, a, kThreads, smem, stream);
    return launch_cluster(decode_kernel<HD, kPaged, kMaxTasks>, a, kThreads, smem,
                          stream);
  }
}

template <typename T, bool kPaged>
int dispatch_hd(DecodeArgs& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16, kPaged>(a, stream);
    case 32: return launch<T, 32, kPaged>(a, stream);
    case 64: return launch<T, 64, kPaged>(a, stream);
    case 128: return launch<T, 128, kPaged>(a, stream);
    case 256: return launch<T, 256, kPaged>(a, stream);
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

}  // namespace

// Returns 0 on success, a cudaError_t code after a failed launch (a refused
// cluster launch included), or -1 for arguments the kernel does not take
// (the Python wrapper checks first).
extern "C" int repro_decode_attention(const void* q, const void* k,
                                      const void* v, void* o, int dtype,
                                      int P, int B, int H, int G, int L,
                                      int hd, const long long* strides, int t,
                                      float scale, void* stream) {
  if (G <= 0 || L <= 0 || t < 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, L, {}, {}, {}, {},
               t, nullptr, nullptr, nullptr, 0, 0, scale, 1, G, 1};
  return dispatch<false>(a, dtype, hd, strides, stream);
}

// Paged form: k/v are the pool [P, n_pages, ps, Hs, hd] through strides;
// bt [B, n_pg] and tv [B] are int32 in device memory, and so is the head
// map hm [H] (q's kv head h reads stored head hm[h] < Hs), or nullptr for
// the identity (Hs == H). Same return codes.
extern "C" int repro_decode_attention_paged(const void* q, const void* k,
                                            const void* v, void* o,
                                            const int* bt, const int* tv,
                                            const int* hm, int dtype, int P,
                                            int B, int H, int G, int n_pg,
                                            int ps, int hd,
                                            const long long* strides,
                                            float scale, void* stream) {
  if (G <= 0 || n_pg <= 0 || ps <= 0) return -1;
  DecodeArgs a{q, k, v, o, P, B, H, G, n_pg * ps, {}, {}, {}, {},
               0, bt, tv, hm, n_pg, ps, scale, 1, G, 1};
  return dispatch<true>(a, dtype, hd, strides, stream);
}
