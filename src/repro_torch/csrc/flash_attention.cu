// Flash attention for prefill: tiled attention with an online fp32 softmax,
// GQA-folded query rows, and the JAX package's five mask kinds.
//
// Replaces: the JAX package's kernels/flash_attention.py, `flash_attention`
// (its `_kernel` behind the one pallas_call).
//
// What bounds it on the card: at the prefill shapes of the main path
// (S = 128, hd = 64, causal, 8 folded kv heads at B = 4) the work is 0.54
// GFLOP and 2.4 MB: half a microsecond of tensor-core time, under one of
// device-memory time. What is left is latency: how soon each block has its
// keys in shared memory and how few instructions stand between a key tile
// and its contribution to the output. Products on the CUDA cores in fp32
// (this kernel's first version) were bound by shared-memory reads, about
// 30x SDPA's time.
//
// bfloat16: tensor cores (mma.sync m16n8k16, FlashAttention-2 style).
//  * A block is 4 warps and 64 GQA-folded query rows (row = position * g
//    + head, as in the JAX kernel), so a kv tile in shared memory serves
//    the g query heads of its kv head. Grid: (batch x kv head, row tiles).
//    Each warp owns 16 rows; their Q is staged once and held in registers
//    as mma A fragments (ldmatrix).
//  * K and V are staged by cp.async in 16-byte copies, two stages in
//    flight, each stage max(64, block_n) keys; rows at or past T, and past
//    the block's last tile, are zero-filled (src size 0), never read.
//    Staged rows are padded by 16 bytes, so the 8 row addresses of every
//    ldmatrix fall in distinct banks.
//  * S = Q K^T on the tensor cores (ldmatrix on K), then the mask and the
//    online softmax in fp32 registers, row max across the quad of threads
//    that share a row by shuffles. P is rounded to bf16 and O += P V on the
//    tensor cores (ldmatrix.trans on V); O stays in fp32 registers.
//  * The caller's block_n (16, 32, 64 or 128) is the online-softmax tile:
//    one max, one correction and one rescale of O per block_n keys, as the
//    fp32 body and the plain "chunked:<kb>" core group it. At the main
//    path's block_n = 16 a tile is exactly the k depth of one P V mma.
//    Each thread keeps its part of the row sum l and the quad adds the
//    parts at the end: a fixed grouping by key position.
//  * Why mma.sync and not wgmma with TMA: a block does ~2 MFLOP at S = 128;
//    the kernel is bound by load latency and overlap, not by tensor-core
//    rate, and 16-row mma tiles fit the GQA fold and per-row masks as they
//    are.
//
// float32: the CUDA cores, the first version's arithmetic (fp32 on tensor
// cores would be TF32, three decimal digits; fp32 is the type of the
// parity runs).
//  * Grid over (batch x kv head, tiles of 32 folded query rows); four
//    threads per query row, each owning every fourth element of hd: the
//    dot product is reduced with two warp shuffles and the shared-memory
//    reads of one key row fall in distinct banks.
//
// Contracts both bodies keep:
//  * Masks: causal (with a prefix-LM prefix), window, chunk and bidir,
//    on absolute positions q0 + row / g and k0 + key, each row's as one
//    key span (key_span); keys at or past T are masked as well (k_limit).
//    The bf16 body tests keys one by one only in tiles that some row of
//    the warp does not see whole.
//  * Offsets: q0 is one int for the launch, or one per batch row read from
//    device memory (the engine's bucketed prefill, where each radix-hit row
//    starts at its own context length). Each block uses its row's q0 for
//    both the mask and the tile range, so equal per-row offsets give the
//    scalar launch's output bit for bit.
//  * Layout: q and the output as [B, S, H, g, hd], k and v as
//    [B, T, H, hd], read through strides (hd contiguous). No transposes.
//    The bf16 body copies 16 bytes at a time, so it takes only pointers
//    and row strides that are multiples of 16 bytes; the host wrapper
//    raises on any other layout (the main path's tensors are contiguous).
//  * The kv tile width block_n is fixed by the caller and never clamped to
//    T. A row's reduction grouping then depends only on key positions
//    relative to k0 and on block_n, never on T, S, B or another row's q0,
//    which keeps right-padding of the key axis bit-transparent:
//     - A fully masked tile after the row's first allowed key is an exact
//       no-op: kNegInf is finite, so m stays, corr = exp(0) = 1, every p
//       is exactly 0 (and so is its bf16 rounding), and O + 0 * V = O.
//       Keys past T are zero-filled, so 0 * V stays 0; keys in T but
//       masked may hold any finite junk.
//     - A tile before the row's first allowed key gives p = 1 on finite
//       values; the first allowed key then wipes it with
//       corr = exp(kNegInf - m) = 0.
//    So skipping tiles that every row of a block (bf16: of a warp) masks
//    (keys above the causal horizon, below a window or chunk start) is
//    exact too, and the tile range may depend on the block's rows.
//
// A query row that may attend to no key at all (no mask of this repo makes
// one: the diagonal is always allowed) gets zeros, or the mean of the values
// in the tiles its block visited, where the plain version averages all T.
#include <climits>

#include "common.cuh"

using namespace repro;

namespace {

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

// The mask of one query row as a key span: kpos is allowed iff
// lo <= kpos <= hi, or kpos < prefix_end(a, k_limit) (a prefix-LM prefix).
//   causal: kpos <= qpos;  window: qpos - window < kpos <= qpos;
//   chunk:  kpos <= qpos in qpos's chunk;  bidir: every key;
// and always kpos < k_limit (keys at or past T). Positions are
// non-negative, so "kpos / chunk == qpos / chunk" under causality is
// kpos >= (qpos / chunk) * chunk: no division per key.
__device__ __forceinline__ int2 key_span(const FlashArgs& a, int qpos,
                                         int k_limit) {
  int lo = INT_MIN, hi = qpos;
  if (a.kind == kBidir) hi = INT_MAX;
  if (a.kind == kWindow) lo = qpos - a.window + 1;
  if (a.kind == kChunk) lo = (qpos / a.chunk) * a.chunk;
  return make_int2(lo, min(hi, k_limit - 1));
}

__device__ __forceinline__ int prefix_end(const FlashArgs& a, int k_limit) {
  return a.kind == kCausal && a.prefix_len > 0 ? min(a.prefix_len, k_limit) : INT_MIN;
}

// Tiles [x, y) of width bn (counted from k0) that folded rows r_lo..r_hi
// may attend to: every tile outside is fully masked for all of them.
__device__ __forceinline__ int2 tile_range(const FlashArgs& a, int q0, int r_lo,
                                           int r_hi, int bn) {
  const int qmin = q0 + r_lo / a.G, qmax = q0 + r_hi / a.G;
  int lo = a.k0, hi = a.k0 + a.T;
  if (a.kind != kBidir) {
    hi = min(hi, max(qmax + 1, a.kind == kCausal ? a.prefix_len : 0));
    if (a.kind == kWindow) lo = max(lo, qmin - a.window + 1);
    if (a.kind == kChunk) lo = max(lo, (qmin / a.chunk) * a.chunk);
  }
  return make_int2(lo > a.k0 ? (lo - a.k0) / bn : 0,
                   hi > a.k0 ? (hi - a.k0 + bn - 1) / bn : 0);
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // folded query rows per block
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kStages = 2;                // cp.async stages in flight

template <int HD, int BN>
struct MmaShape {
  static constexpr int kPitch = HD + 8;                 // staged row, bf16
  static constexpr int kStageKeys = BN > 64 ? BN : 64;  // keys per stage
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kPitch * (kMmaRows + kStages * 2 * kStageKeys);
};

template <int HD, int BN>
__global__ void __launch_bounds__(kMmaThreads) flash_mma_kernel(FlashArgs a) {
  using Shape = MmaShape<HD, BN>;
  constexpr int kPitch = Shape::kPitch, kSK = Shape::kStageKeys;
  constexpr int kSeg = HD / 8;     // 16-byte segments per row
  constexpr int kKSteps = HD / 16; // mma k steps over hd in S = Q K^T
  constexpr int kNT = BN / 8;      // 8-key column tiles of S per block_n tile
  constexpr int kDT = HD / 8;      // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(flash_smem);  // [kMmaRows][kPitch]
  __nv_bfloat16* kv_s = q_s + kMmaRows * kPitch;  // [stage][K, V][kSK][kPitch]

  const int bh = blockIdx.x;
  const int h = bh % a.H, b = bh / a.H;
  const int q0 = a.q0_rows ? a.q0_rows[b] : a.q0;
  const int n_rows = a.S * a.G;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row_base = blockIdx.y * kMmaRows;
  const int w_lo = row_base + warp * 16;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + h * a.vs[2];

  // Tiles any row of the block may attend to (what is staged), and those
  // of this warp's 16 rows (what it computes).
  const int2 blk = tile_range(a, q0, row_base,
                              min(n_rows, row_base + kMmaRows) - 1, BN);
  const int2 mine = w_lo < n_rows
                        ? tile_range(a, q0, w_lo, min(n_rows, w_lo + 16) - 1, BN)
                        : make_int2(0, 0);
  const int key_begin = blk.x * BN;
  const int kv_end = min(a.T, blk.y * BN);  // staged keys past this are zeros
  const int n_stages = blk.y > blk.x ? (blk.y * BN - key_begin + kSK - 1) / kSK : 0;

  for (int i = tid; i < kMmaRows * kSeg; i += kMmaThreads) {
    const int r = i / kSeg, c = i % kSeg, gr = row_base + r;
    const bool ok = gr < n_rows;
    cp_async16(q_s + r * kPitch + c * 8,
               ok ? qb + (gr / a.G) * a.qs[1] + (gr % a.G) * a.qs[3] + c * 8 : qb,
               ok ? 16 : 0);
  }
  auto load_stage = [&](int st) {
    __nv_bfloat16* k_st = kv_s + (st % kStages) * 2 * kSK * kPitch;
    __nv_bfloat16* v_st = k_st + kSK * kPitch;
    const int first = key_begin + st * kSK;
    for (int i = tid; i < kSK * kSeg; i += kMmaThreads) {
      const int r = i / kSeg, c = i % kSeg, kl = first + r;
      const bool ok = kl < kv_end;
      cp_async16(k_st + r * kPitch + c * 8, ok ? kb + kl * a.ks[1] + c * 8 : kb,
                 ok ? 16 : 0);
      cp_async16(v_st + r * kPitch + c * 8, ok ? vb + kl * a.vs[1] + c * 8 : vb,
                 ok ? 16 : 0);
    }
  };
  // Q and the first kStages stages in flight at once, one group each.
  if (n_stages > 0) load_stage(0);
  cp_async_commit();
#pragma unroll
  for (int st = 1; st < kStages; ++st) {
    if (st < n_stages) load_stage(st);
    cp_async_commit();
  }

  unsigned qf[kKSteps][4];
  float o[kDT][4];
#pragma unroll
  for (int d = 0; d < kDT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // rows g, g + 8
  const float scale_log2 = a.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  const int k_limit = a.k0 + a.T;
  const int2 span0 = key_span(a, q0 + min(w_lo + g, n_rows - 1) / a.G, k_limit);
  const int2 span1 = key_span(a, q0 + min(w_lo + g + 8, n_rows - 1) / a.G, k_limit);
  const int plen = prefix_end(a, k_limit);

  for (int st = 0; st < n_stages; ++st) {
    cp_async_wait<kStages - 1>();  // stage st is in (one later group may fly)
    __syncthreads();
    if (st == 0) {
#pragma unroll
      for (int ks = 0; ks < kKSteps; ++ks)
        ldsm_x4(qf[ks], q_s + (warp * 16 + lane % 16) * kPitch + ks * 16 + (lane / 16) * 8);
    }
    const __nv_bfloat16* k_st = kv_s + (st % kStages) * 2 * kSK * kPitch;
    const __nv_bfloat16* v_st = k_st + kSK * kPitch;
    const int tile0 = (key_begin + st * kSK) / BN;
#pragma unroll 1
    for (int tt = 0; tt < kSK / BN; ++tt) {
      const int kt = tile0 + tt;
      if (kt < mine.x || kt >= mine.y) continue;  // fully masked for this warp
      const __nv_bfloat16* k_t = k_st + tt * BN * kPitch;
      const __nv_bfloat16* v_t = v_st + tt * BN * kPitch;

      float s[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
        if constexpr (kKSteps % 2 == 0) {
#pragma unroll
          for (int ks = 0; ks < kKSteps; ks += 2) {
            unsigned kf[4];  // k steps ks and ks + 1 of keys nt*8..nt*8+7
            ldsm_x4(kf, k_t + (nt * 8 + lane % 8) * kPitch + ks * 16 + (lane / 8) * 8);
            mma_bf16(s[nt], qf[ks], kf[0], kf[1]);
            mma_bf16(s[nt], qf[ks + 1], kf[2], kf[3]);
          }
        } else {  // hd = 16: one k step
          unsigned kf[2];
          ldsm_x2(kf, k_t + (nt * 8 + lane % 8) * kPitch + ((lane / 8) % 2) * 8);
          mma_bf16(s[nt], qf[0], kf[0], kf[1]);
        }
      }

      // Mask, then the online softmax over this block_n tile (log2 domain).
      // A tile that every row of the warp sees whole skips the per-key test.
      const int kfirst = a.k0 + kt * BN, klast = kfirst + BN - 1;
      const bool whole = __all_sync(
          0xffffffffu, (kfirst >= span0.x && klast <= span0.y && kfirst >= span1.x &&
                        klast <= span1.y) || klast < plen);
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kfirst + nt * 8 + 2 * t4 + (e & 1);
          const int2 span = e < 2 ? span0 : span1;
          const bool ok = whole || (kpos >= span.x && kpos <= span.y) || kpos < plen;
          s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        }
        mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the quad sharing each row
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

      // O += P V: the S accumulators of two 8-key tiles are the A fragment
      // of one 16-key k step.
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int d = 0; d < kDT; d += 2) {
          unsigned vf[4];  // keys kk*16.. of hd columns d*8.. and (d+1)*8..
          ldsm_x4_trans(vf, v_t + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kPitch +
                                d * 8 + (lane / 16) * 8);
          mma_bf16(o[d], pa, vf[0], vf[1]);
          mma_bf16(o[d + 1], pa, vf[2], vf[3]);
        }
      }
    }
    if (st + kStages < n_stages) {
      __syncthreads();  // every warp is done with this stage's buffer
      load_stage(st + kStages);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv[2] = {1.f / fmaxf(l0, 1e-30f), 1.f / fmaxf(l1, 1e-30f)};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = w_lo + g + 8 * half;
    if (r >= n_rows) continue;
    __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] +
                        (r / a.G) * a.os[1] + h * a.os[2] + (r % a.G) * a.os[3];
#pragma unroll
    for (int d = 0; d < kDT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(op + d * 8 + 2 * t4) = __floats2bfloat162_rn(
          o[d][2 * half] * inv[half], o[d][2 * half + 1] * inv[half]);
  }
}

template <int HD, int BN>
int launch_mma(const FlashArgs& a, cudaStream_t stream) {
  constexpr size_t smem = MmaShape<HD, BN>::kSmem;
  cudaError_t err = allow_smem(flash_mma_kernel<HD, BN>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S * a.G + kMmaRows - 1) / kMmaRows);
  flash_mma_kernel<HD, BN><<<grid, kMmaThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int dispatch_bn(const FlashArgs& a, cudaStream_t stream) {
  switch (a.block_n) {
    case 16: return launch_mma<HD, 16>(a, stream);
    case 32: return launch_mma<HD, 32>(a, stream);
    case 64: return launch_mma<HD, 64>(a, stream);
    case 128: return launch_mma<HD, 128>(a, stream);
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kRows = 32;          // folded query rows per block
constexpr int kThreadsPerRow = 4;  // threads sharing one query row
constexpr int kThreads = kRows * kThreadsPerRow;
constexpr int kBatch = 8;          // kv loads in flight per thread

inline size_t smem_bytes(int block_n, int hd) {
  return sizeof(float) * (2 * size_t(block_n) * hd + size_t(kRows) * block_n);
}

template <int HD>
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

  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] + h * a.vs[2];

  float qr[DPT], acc[DPT];
  if (row_ok) {
    const float* qp = static_cast<const float*>(a.q) + b * a.qs[0] +
                      (r / a.G) * a.qs[1] + h * a.qs[2] + (r % a.G) * a.qs[3];
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = qp[i * kThreadsPerRow + part];
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  const int row_lo = blockIdx.y * kRows;
  const int2 tiles = tile_range(a, q0, row_lo, min(n_rows, row_lo + kRows) - 1, BN);
  const int k_limit = a.k0 + a.T;
  const int2 span = key_span(a, qpos, k_limit);
  const int plen = prefix_end(a, k_limit);

  for (int kt = tiles.x; kt < tiles.y; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    // kBatch loads per thread in flight before the first store.
    for (int e0 = tid; e0 < BN * HD; e0 += kThreads * kBatch) {
      float kv[kBatch], vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads, kl = kt * BN + e / HD, d = e % HD;
        const bool in = e < BN * HD && kl < a.T;  // ragged edge: finite zeros
        kv[u] = in ? kb[kl * a.ks[1] + d] : 0.f;
        vv[u] = in ? vb[kl * a.vs[1] + d] : 0.f;
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
      const bool ok = row_ok && ((kpos >= span.x && kpos <= span.y) || kpos < plen);
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
    float* op = static_cast<float*>(a.o) + b * a.os[0] + (r / a.G) * a.os[1] +
                h * a.os[2] + (r % a.G) * a.os[3];
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < DPT; ++i) op[i * kThreadsPerRow + part] = acc[i] / l_safe;
  }
}

template <int HD>
int launch_fp32(const FlashArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.block_n, HD);
  cudaError_t err = allow_smem(flash_kernel<HD>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B * a.H, (a.S * a.G + kRows - 1) / kRows);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const FlashArgs& a, int dtype, int hd, cudaStream_t stream) {
  if (dtype == kFloat32) {
    switch (hd) {
      case 16: return launch_fp32<16>(a, stream);
      case 32: return launch_fp32<32>(a, stream);
      case 64: return launch_fp32<64>(a, stream);
      case 128: return launch_fp32<128>(a, stream);
      default: return -1;
    }
  }
  if (dtype == kBFloat16) {
    switch (hd) {
      case 16: return dispatch_bn<16>(a, stream);
      case 32: return dispatch_bn<32>(a, stream);
      case 64: return dispatch_bn<64>(a, stream);
      case 128: return dispatch_bn<128>(a, stream);
      default: return -1;
    }
  }
  return -1;
}

// The bf16 body's 16-byte copies: pointers and row strides (elements of
// 2 bytes) must be multiples of 16 bytes.
bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
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
  if (block_n <= 0 || kind < 0 || kind > kBidir ||
      (kind == kWindow && window <= 0) || (kind == kChunk && chunk <= 0) ||
      S <= 0 || T <= 0 || G <= 0)
    return -1;
  if (dtype == kFloat32 && smem_bytes(block_n, hd) > 227 * 1024) return -1;
  if (dtype == kBFloat16) {
    if (!aligned16(q) || !aligned16(k) || !aligned16(v)) return -1;
    for (int i = 0; i < 10; ++i)  // q (batch, position, head, group), k, v
      if (strides[i] % 8 != 0) return -1;
  }
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
  return dispatch(a, dtype, hd, static_cast<cudaStream_t>(stream));
}
