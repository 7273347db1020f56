// Flash attention (K6) and flash decode (K7) for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/attention/flash.py:
//   K6 flash_attention (:95)  - online-softmax attention, GQA, causal and
//                               packed-segment masks (LM prefill)
//   K7 flash_decode    (:193) - one-token attention over a KV cache masked
//                               past `pos` (LM decode)
//
// Layouts (row-major, contiguous), T = float or __nv_bfloat16:
//   q (B, Sq, H, D); k, v (B, Skv, Kv, D); out (B, Sq, H, D) T
//   segment ids (B, S) int32 or null;   query head h reads KV head h / G,
//   G = H / Kv (any G, e.g. minitron-4b's 3)
//
// Semantics are the Pallas kernels', not SDPA's.  Scores are float32
// (tensor-core products of bf16 inputs with float32 accumulators, or
// float32 FMAs), multiplied by sm_scale; masked scores are the finite
// -1e30, never -inf.  The online softmax keeps per row m (running max), l
// (running sum of the float32 p) and a float32 accumulator; p is rounded
// to T before the P.V product, the output is acc / l (l = 0 -> 1) rounded
// to T.  A KV tile in which a row is fully masked gives m = -1e30 and
// p = exp(0) = 1 there, and the first tile with an unmasked score wipes it
// with alpha = exp(-1e30 - m) = 0, as in the Pallas kernel; with Sq == Skv
// every row has its diagonal unmasked, so no row ends fully masked.
// Positions past the ragged end (Skv not a multiple of the tile) are not
// scores at all: they get p = 0 and never enter the max.  The bf16 kernel
// works in base 2 (scores times sm_scale * log2(e), exp2), which changes
// no masked case: a masked score stays -1e30 beside scores of size ~10.
//
// K6 bound on an H100: operations.  Causal attention does 2*B*S^2*H*D
// FLOP (the two products over the lower triangle), 206 GFLOP at B = 2,
// S = 4096, H = 24, D = 128: 0.208 ms at 989 TFLOP/s bf16, against 0.2 ms
// of bytes only if every input were read once.  Design (bf16, after
// FlashAttention-3).  The TPU kernel runs a sequential KV grid axis
// carrying (m, l, acc) in VMEM scratch; on Hopper blocks carry nothing
// between them, so one block per (128 query rows, query head, batch) loops
// over 128-position KV tiles itself, the heaviest causal query tiles first.
// Warp roles (384 threads): warpgroups 0 and 1 are consumers, 64 query
// rows each; warpgroup 2 is the producer, one thread of which loads Q once
// and K/V tiles into a ring of 2 stages with TMA (3-D maps over the
// (B, S, H, D) tensors, so a head's rows strided by H*D come in as one box,
// zero-filled past S), completing on mbarriers; the consumers free a stage
// on its "empty" barrier.  setmaxnreg moves registers from the producer
// (24) to the consumers (240).  A consumer runs S = Q.K^T as wgmma
// m64n128k16 with both operands in shared memory and the float32 scores in
// registers; the masks, the row max and sum (quad shuffles) and the
// rescale of the output accumulator by alpha all happen in registers; p is
// rounded to bf16 in registers, whose layout is the A operand of the P.V
// wgmma (m64nDk16, V read MN-major from shared memory).  Neither the
// scores nor the output touch shared memory; the output is divided by l
// and stored from registers.  Tiles are 128-byte swizzled (64-byte at
// D = 32), in D / 64 column blocks of 64.  Shared memory at D = 128: Q
// 32 KB + 2 stages x (K 32 KB + V 32 KB) = 160 KB of the 227 KB, one block
// an SM.  D in {32, 64, 128}.  Each step waits for its own products, so a
// consumer's tensor work and its softmax (64 exp2 a thread a tile on the
// special-function unit) alternate, and only the other consumer fills the
// gaps.  Later work: explicit ping-pong of the two consumers on named
// barriers and, with it, overlapping a tile's softmax with its own
// products (issuing the previous tile's P.V behind this tile's Q.K^T
// alone ran slower on the card); the causal diagonal tile is computed
// whole and masked, and the first consumer computes tiles its rows never
// see; the output is stored from registers (4-byte stores), not through
// TMA.  float32 inputs take an FMA
// kernel on the CUDA cores (TF32 would miss the 1e-4 tolerance): one block
// per (64 query rows, head, batch), 4 warps of 16 rows, the score and
// output tiles in shared memory, off the main path.
//
// K7 bound on an H100: bytes.  A step reads the cache up to pos once,
// 2*B*(pos+1)*Kv*D*sizeof(T): 33.6 MB at B = 2, pos = 4095 (0.010 ms at
// 3.35 TB/s), 1.07 GB at B = 8, pos = 32767 (0.321 ms).  Design.  The TPU
// grid (B*Kv, KV blocks) runs its KV axis in order; at B = 2 that is 16
// (batch, KV head) pairs, 16 of 132 SMs.  So K7 splits the cache ("flash
// decoding"): pass 1 runs one block per (chunk of positions, KV head,
// batch) over chunks that start at or before pos only (pos is a host
// integer, so the grid is sized to it); each block streams its chunk's K
// and V through shared memory 64 positions at a time, with coalesced
// 4-byte loads, runs the online softmax for the G query heads of its KV
// head, and writes its partial (m, l, acc) in float32.  Pass 2 merges the
// partials of each (batch, head): M = max m_c, l = sum l_c e^(m_c - M),
// out = sum acc_c e^(m_c - M) / l.  The wrapper picks the chunk (64 to
// 512 positions) so that pass 1 has about two blocks per SM where the
// cache allows.  Double-buffered (cp.async or TMA) loads are later work.
//
// Contract (checked by the wrappers in flash.py): contiguous tensors on one
// device, 16-byte aligned, D in {32, 64, 128}; K6: causal or segment ids
// need Sq == Skv; K7: 0 <= pos < Smax.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the finite mask value of flash.py:30
constexpr int kThreads = 128;      // 4 warps (float32 K6, K7)
constexpr int kBQ = 64;            // float32 K6 query rows per block
constexpr int kBKV = 64;           // float32 K6 / K7 positions per KV tile
constexpr int kRowsPerWarp = 16;

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  }
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ------------------------------------------------------- K6, bf16 wgmma ----

constexpr int kWgThreads = 384;   // 2 consumer warpgroups + 1 producer
constexpr int kWgBQ = 128;        // query rows a block (64 a consumer)
constexpr int kWgBKV = 128;       // positions a KV tile
constexpr int kWgStages = 2;      // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of one bf16 K6 block (offsets from a 1024-byte aligned
// base): Q, then the K stages, then the V stages, then the barriers.  Each
// tile is D / kCols column blocks of (rows x kSw bytes), 128-byte swizzled
// (64-byte at D = 32).
template <int D>
struct WgLayout {
  static constexpr int kSw = D * 2 >= 128 ? 128 : D * 2;  // bytes a row
  static constexpr int kCols = kSw / 2;                   // bf16 a block
  static constexpr int kBlocks = D / kCols;
  static constexpr int q_block = kWgBQ * kSw;             // bytes
  static constexpr int kv_block = kWgBKV * kSw;
  static constexpr int q_bytes = kBlocks * q_block;
  static constexpr int kv_bytes = kBlocks * kv_block;     // one K or V tile
  static constexpr int k_off = q_bytes;
  static constexpr int v_off = k_off + kWgStages * kv_bytes;
  static constexpr int bar_off = v_off + kWgStages * kv_bytes;
  // q_full, full[stages], empty[stages]; plus the alignment slack
  static constexpr int bytes = bar_off + 8 * (1 + 2 * kWgStages) + 1024;
};

// 2^x on the special-function unit (flushes denormal results to 0, whose
// p would round to 0 in bf16 anyway).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (D == 128) {
    hopper::wgmma_rs_n128<1>(o, a, b, 1);
  } else if constexpr (D == 64) {
    hopper::wgmma_rs_n64<1>(o, a, b, 1);
  } else {
    hopper::wgmma_rs_n32<1>(o, a, b, 1);
  }
}

template <int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ out, int sq, int skv,
                             int h, int kvh, int causal, float scale_log2) {
  using L = WgLayout<D>;
  extern __shared__ unsigned char k6_raw[];
  unsigned char* smem = hopper::align_1024(k6_raw);
  unsigned char* qs = smem;
  unsigned char* ks = smem + L::k_off;
  unsigned char* vs = smem + L::v_off;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // the heaviest causal query tiles (the last) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  // causal: KV tiles past the diagonal are skipped (flash.py:81-85)
  const int kv_end = causal ? min(skv, q0 + kWgBQ) : skv;
  const int n_tiles = (kv_end + kWgBKV - 1) / kWgBKV;

  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every TMA load ----
    hopper::reg_dealloc<24>();
    if (tid == 256) {
      hopper::mbar_arrive_expect_tx(q_full, L::q_bytes);
      for (int c = 0; c < L::kBlocks; ++c) {
        hopper::tma_load_4d(qs + c * L::q_block, &qmap, q_full, c * L::kCols,
                            head, q0, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % kWgStages;
        const uint32_t phase = (t / kWgStages) & 1;
        hopper::mbar_wait(&empty[st], phase ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], 2 * L::kv_bytes);
        for (int c = 0; c < L::kBlocks; ++c) {
          hopper::tma_load_4d(ks + st * L::kv_bytes + c * L::kv_block, &kmap,
                              &full[st], c * L::kCols, kv_head, t * kWgBKV,
                              b);
          hopper::tma_load_4d(vs + st * L::kv_bytes + c * L::kv_block, &vmap,
                              &full[st], c * L::kCols, kv_head, t * kWgBKV,
                              b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    hopper::reg_alloc<240>();
    const int lane = tid % 32;
    const int row_a = q0 + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
    const int row_b = row_a + 8;
    const int wg_first = q0 + wg * 64;   // this consumer's first row
    const int use_seg = seg != nullptr;
    const int* segb = use_seg ? seg + (int64_t)b * skv : nullptr;
    const int qseg_a = use_seg && row_a < sq ? segb[row_a] : 0;
    const int qseg_b = use_seg && row_b < sq ? segb[row_b] : 0;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float s[kWgBKV / 2];
#pragma unroll
    for (int i = 0; i < kWgBKV / 2; ++i) s[i] = 0.0f;
    float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;

    hopper::mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int st = t % kWgStages;
      const int j0 = t * kWgBKV;
      hopper::mbar_wait(&full[st], (t / kWgStages) & 1);

      // S = Q . K^T, both K-major in shared memory
      const unsigned char* kt = ks + st * L::kv_bytes;
      hopper::wgmma_fence();
      hopper::fence_regs(s);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / (L::kCols / 16);
        const int off = (kk % (L::kCols / 16)) * 32;
        const uint64_t da = hopper::smem_desc(
            qs + c * L::q_block + wg * 64 * L::kSw + off, 16, 8 * L::kSw,
            L::kSw);
        const uint64_t db = hopper::smem_desc(kt + c * L::kv_block + off, 16,
                                              8 * L::kSw, L::kSw);
        hopper::wgmma_ss_n128<0>(s, da, db, kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(s);

      // masks, in registers: element i is row (i & 2 ? b : a), column
      // j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1)
      const bool edge = j0 + kWgBKV > skv;
      const bool diag = causal && j0 + kWgBKV - 1 > wg_first;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kWgBKV / 2; ++i) {
        float x = s[i] * scale_log2;
        if (edge || diag || use_seg) {
          const int col = j0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
          const int row = (i & 2) ? row_b : row_a;
          if (col >= skv) {
            x = -INFINITY;   // not a score: p = 0, out of the max
          } else if ((causal && col > row) ||
                     (use_seg && segb[col] != ((i & 2) ? qseg_b : qseg_a))) {
            x = kNegInf;
          }
        }
        s[i] = x;
        if (i & 2) {
          mx_b = fmaxf(mx_b, x);
        } else {
          mx_a = fmaxf(mx_a, x);
        }
      }
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = fast_exp2(m_a - mn_a);
      const float alpha_b = fast_exp2(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < kWgBKV / 2; ++i) {
        const float p = fast_exp2(s[i] - ((i & 2) ? mn_b : mn_a));
        s[i] = p;
        if (i & 2) {
          sum_b += p;
        } else {
          sum_a += p;
        }
      }
      // each thread keeps its own share of l; the quad sums it at the end
      l_a = l_a * alpha_a + sum_a;
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= (i & 2) ? alpha_b : alpha_a;

      // p rounded to bf16: the S fragment of columns [16 kk, 16 kk + 16) is
      // the A fragment of k-step kk
      uint32_t pa[kWgBKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < kWgBKV / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }

      // O += P . V, V MN-major: 16 positions a k-step
      const unsigned char* vt = vs + st * L::kv_bytes;
      hopper::wgmma_fence();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kWgBKV / 16; ++kk) {
        const uint64_t db = hopper::smem_desc(vt + kk * 16 * L::kSw,
                                              L::kv_block, 8 * L::kSw,
                                              L::kSw);
        wgmma_pv<D>(o, pa[kk], db);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::mbar_arrive(&empty[st]);
    }

    l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
    l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
    const float safe_a = l_a == 0.0f ? 1.0f : l_a;
    const float safe_b = l_b == 0.0f ? 1.0f : l_b;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = (i & 2) ? row_b : row_a;
      if (row >= sq) continue;
      const float safe = (i & 2) ? safe_b : safe_a;
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((int64_t)b * sq + row) * h + head) * D + col) =
          __floats2bfloat162_rn(o[i] / safe, o[i + 1] / safe);
    }
  }
}

// The (B, S, heads, D) bf16 tensor as a 4-D TMA map whose box is
// (one column block, one head, `rows` positions, one batch).
template <int D>
int encode_qkv_map(CUtensorMap* map, const void* base, int b, int s,
                   int heads, int rows) {
  using L = WgLayout<D>;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)s * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)L::kCols, 1, (cuuint32_t)rows, 1};
  return hopper::encode_bf16_map(map, base, 4, dims, strides, box, L::kSw);
}

template <int D>
int launch_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                 const int* seg, void* out, int b, int sq,
                                 int skv, int h, int kvh, int causal,
                                 float sm_scale, cudaStream_t stream) {
  using L = WgLayout<D>;
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_qkv_map<D>(&qmap, q, b, sq, h, kWgBQ);
  if (rc == 0) rc = encode_qkv_map<D>(&kmap, k, b, skv, kvh, kWgBKV);
  if (rc == 0) rc = encode_qkv_map<D>(&vmap, v, b, skv, kvh, kWgBKV);
  if (rc != 0) return rc;
  auto kernel = flash_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kWgBQ - 1) / kWgBQ, h, b);
  kernel<<<grid, kWgThreads, L::bytes, stream>>>(
      qmap, kmap, vmap, seg, static_cast<__nv_bfloat16*>(out), sq, skv, h,
      kvh, causal, sm_scale * kLog2e);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ K6, float32 FMA ----

// Shared-memory layout of one float32 K6 block.  Row strides are padded by
// 1 (a K row per lane: a stride of D + 1 words spreads the lanes over the
// banks).
template <int D>
struct K6Layout {
  static constexpr int ldt = D + 1;       // Q, K, V
  static constexpr int lds = kBKV + 4;    // scores
  static constexpr int ldp = kBKV + 4;    // P
  static constexpr int ldo = D + 4;       // output
  static constexpr size_t tile = round_up(sizeof(float) * kBQ * ldt, 128);
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t p_off =
      s_off + round_up(sizeof(float) * kBQ * lds, 128);
  static constexpr size_t o_off =
      p_off + round_up(sizeof(float) * kBQ * ldp, 128);
  static constexpr size_t stat_off =
      o_off + round_up(sizeof(float) * kBQ * ldo, 128);
  // m, l, alpha (float) and the query / key segment ids (int)
  static constexpr size_t bytes = stat_off + 5 * kBQ * 4;
};

// Rows [first, first + 64) of a sequence whose row r starts at
// src + r * stride, into a tile with row stride ld; zero past `limit`.
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int first, int limit, int d) {
  for (int e = threadIdx.x; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * ld + c] = first + r < limit ? src[(first + r) * stride + c] : 0.0f;
  }
}

// S[rows of this warp][0, 64) = Q . K^T (unscaled): lane owns score
// columns lane and lane + 32.
template <int D>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks,
                                            float* s, int r0) {
  using L = K6Layout<D>;
  const int lane = threadIdx.x % 32;
  float acc[kRowsPerWarp][2];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) acc[i][0] = acc[i][1] = 0.0f;
  for (int d = 0; d < D; ++d) {
    const float k0 = ks[lane * L::ldt + d];
    const float k1 = ks[(lane + 32) * L::ldt + d];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float qv = qs[(r0 + i) * L::ldt + d];
      acc[i][0] = fmaf(qv, k0, acc[i][0]);
      acc[i][1] = fmaf(qv, k1, acc[i][1]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    s[(r0 + i) * L::lds + lane] = acc[i][0];
    s[(r0 + i) * L::lds + lane + 32] = acc[i][1];
  }
}

// O[rows of this warp] += P . V (O already rescaled).
template <int D>
__device__ __forceinline__ void tile_pv(const float* p, const float* vs,
                                        float* o, int r0) {
  using L = K6Layout<D>;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
#pragma unroll
    for (int c = lane; c < D; c += 32) {
      float acc = o[r * L::ldo + c];
#pragma unroll 8
      for (int j = 0; j < kBKV; ++j) {
        acc = fmaf(p[r * L::ldp + j], vs[j * L::ldt + c], acc);
      }
      o[r * L::ldo + c] = acc;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ seg,
                           float* __restrict__ out, int sq, int skv, int h,
                           int kvh, int causal, float sm_scale) {
  using L = K6Layout<D>;
  extern __shared__ __align__(128) unsigned char k6_smem[];
  float* qs = reinterpret_cast<float*>(k6_smem + L::q_off);
  float* ks = reinterpret_cast<float*>(k6_smem + L::k_off);
  float* vs = reinterpret_cast<float*>(k6_smem + L::v_off);
  float* s = reinterpret_cast<float*>(k6_smem + L::s_off);
  float* p = reinterpret_cast<float*>(k6_smem + L::p_off);
  float* o = reinterpret_cast<float*>(k6_smem + L::o_off);
  float* m_row = reinterpret_cast<float*>(k6_smem + L::stat_off);
  float* l_row = m_row + kBQ;
  float* alpha_row = l_row + kBQ;
  int* qseg = reinterpret_cast<int*>(alpha_row + kBQ);
  int* kseg = qseg + kBQ;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int r0 = (tid / 32) * kRowsPerWarp;
  // the heaviest causal query tiles (the last) start first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (h / kvh);
  const int64_t q_stride = (int64_t)h * D;
  const int64_t kv_stride = (int64_t)kvh * D;
  const float* qb = q + ((int64_t)b * sq * h + head) * D;
  const float* kb = k + ((int64_t)b * skv * kvh + kv_head) * D;
  const float* vb = v + ((int64_t)b * skv * kvh + kv_head) * D;
  const int use_seg = seg != nullptr;

  load_tile(qs, L::ldt, qb, q_stride, q0, sq, D);
  for (int i = tid; i < kBQ; i += kThreads) {
    m_row[i] = kNegInf;
    l_row[i] = 0.0f;
    qseg[i] = (use_seg && q0 + i < sq) ? seg[(int64_t)b * sq + q0 + i] : 0;
  }
  for (int e = tid; e < kBQ * L::ldo; e += kThreads) o[e] = 0.0f;
  __syncthreads();

  // causal: KV tiles past the diagonal are skipped (flash.py:81-85)
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  for (int j0 = 0; j0 < kv_end; j0 += kBKV) {
    load_tile(ks, L::ldt, kb, kv_stride, j0, skv, D);
    load_tile(vs, L::ldt, vb, kv_stride, j0, skv, D);
    for (int i = tid; i < kBKV; i += kThreads) {
      kseg[i] = (use_seg && j0 + i < skv) ? seg[(int64_t)b * skv + j0 + i]
                                          : 0;
    }
    __syncthreads();

    tile_scores<D>(qs, ks, s, r0);
    __syncwarp();

    // online softmax over this warp's rows; lane owns columns lane, lane+32
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + i;
      const int qi = q0 + r;
      float x[2];
      bool in[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int c = lane + 32 * t;
        const int kj = j0 + c;
        in[t] = kj < skv;
        float val = s[r * L::lds + c] * sm_scale;
        if ((causal && kj > qi) || (use_seg && qseg[r] != kseg[c])) {
          val = kNegInf;
        }
        x[t] = val;
      }
      const float mx = warp_max(fmaxf(in[0] ? x[0] : -INFINITY,
                                      in[1] ? x[1] : -INFINITY));
      const float m_prev = m_row[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = in[0] ? expf(x[0] - m_new) : 0.0f;
      const float p1 = in[1] ? expf(x[1] - m_new) : 0.0f;
      const float sum = warp_sum(p0 + p1);
      const float alpha = expf(m_prev - m_new);
      p[r * L::ldp + lane] = p0;
      p[r * L::ldp + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        m_row[r] = m_new;
        l_row[r] = alpha * l_row[r] + sum;
        alpha_row[r] = alpha;
      }
    }
    __syncwarp();
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = r0 + i;
      const float alpha = alpha_row[r];
      for (int c = lane; c < D; c += 32) o[r * L::ldo + c] *= alpha;
    }
    __syncwarp();
    tile_pv<D>(p, vs, o, r0);
    __syncthreads();  // K, V and segment tiles free for the next load
  }

  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    const int qi = q0 + r;
    if (qi >= sq) break;
    const float l = l_row[r];
    const float safe = l == 0.0f ? 1.0f : l;
    float* dst = out + (((int64_t)b * sq + qi) * h + head) * D;
    for (int c = lane; c < D; c += 32) dst[c] = o[r * L::ldo + c] / safe;
  }
}

template <int D>
int launch_flash_attention_fma(const void* q, const void* k, const void* v,
                               const int* seg, void* out, int b, int sq,
                               int skv, int h, int kvh, int causal,
                               float sm_scale, cudaStream_t stream) {
  using L = K6Layout<D>;
  auto kernel = flash_attention_fma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg, static_cast<float*>(out), sq, skv,
      h, kvh, causal, sm_scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_flash_attention(int bf16, const void* q, const void* k,
                           const void* v, const int* seg, void* out, int b,
                           int sq, int skv, int h, int kvh, int causal,
                           float sm_scale, cudaStream_t stream) {
  if (bf16) {
    return launch_flash_attention_wgmma<D>(q, k, v, seg, out, b, sq, skv, h,
                                           kvh, causal, sm_scale, stream);
  }
  return launch_flash_attention_fma<D>(q, k, v, seg, out, b, sq, skv, h, kvh,
                                       causal, sm_scale, stream);
}

// ------------------------------------------------------------------ K7 ----

// K and V tiles are copied as 32-bit words (two bf16 or one float); the K
// tile's row stride is odd in words, so threads reading different rows hit
// different banks.
template <typename T, int D>
struct K7Layout {
  static constexpr int words = D * (int)sizeof(T) / 4;  // 32-bit words a row
  static constexpr int ldk = words + 1;
  static constexpr int ldv = words;
  static constexpr size_t k_bytes = round_up(4 * kBKV * ldk, 16);
  static constexpr size_t v_bytes = round_up(4 * kBKV * ldv, 16);
  // then, for g query heads: q (g, D) f32, s (g, 64) f32, m, l, alpha (g)
  // f32 and acc (g, D) f32
  static size_t bytes(int g) {
    return k_bytes + v_bytes + 4 * (size_t)g * (2 * D + kBKV + 3);
  }
};

__device__ __forceinline__ void row_pair(const uint32_t* row, int w,
                                         const __nv_bfloat16*, float* out) {
  const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(row + w);
  out[0] = __low2float(pair);
  out[1] = __high2float(pair);
}

__device__ __forceinline__ float row_elem(const uint32_t* row, int i,
                                          const float*) {
  return __uint_as_float(row[i]);
}
__device__ __forceinline__ float row_elem(const uint32_t* row, int i,
                                          const __nv_bfloat16*) {
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(row)[i]);
}

template <typename T, int D>
__device__ __forceinline__ float dot_row(const float* qg, const uint32_t* krow) {
  float acc = 0.0f;
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll 8
    for (int i = 0; i < D; ++i) acc = fmaf(qg[i], __uint_as_float(krow[i]), acc);
  } else {
#pragma unroll 8
    for (int w = 0; w < D / 2; ++w) {
      float kv[2];
      row_pair(krow, w, static_cast<const T*>(nullptr), kv);
      acc = fmaf(qg[2 * w], kv[0], acc);
      acc = fmaf(qg[2 * w + 1], kv[1], acc);
    }
  }
  return acc;
}

// Pass 1: one block per (chunk, KV head, batch); partial (m, l, acc) per
// query head of the group, written to part_ml (B, H, n_chunks, 2) and
// part_acc (B, H, n_chunks, D), float32.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v,
                            float* __restrict__ part_ml,
                            float* __restrict__ part_acc, int smax, int h,
                            int kvh, int pos, int chunk, float sm_scale) {
  using L = K7Layout<T, D>;
  extern __shared__ __align__(128) unsigned char k7_smem[];
  uint32_t* kt = reinterpret_cast<uint32_t*>(k7_smem);
  uint32_t* vt = reinterpret_cast<uint32_t*>(k7_smem + L::k_bytes);
  const int g = h / kvh;
  float* qf = reinterpret_cast<float*>(k7_smem + L::k_bytes + L::v_bytes);
  float* s = qf + g * D;
  float* m_g = s + g * kBKV;
  float* l_g = m_g + g;
  float* alpha_g = l_g + g;
  float* acc = alpha_g + g;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int c = blockIdx.x;
  const int kv_head = blockIdx.y;
  const int b = blockIdx.z;
  const int n_chunks = gridDim.x;
  const int first = c * chunk;
  const int last = min(first + chunk, pos + 1);  // exclusive
  const int64_t row_words = (int64_t)kvh * L::words;  // between positions
  const uint32_t* kb = reinterpret_cast<const uint32_t*>(
                           k + ((int64_t)b * smax * kvh + kv_head) * D);
  const uint32_t* vb = reinterpret_cast<const uint32_t*>(
                           v + ((int64_t)b * smax * kvh + kv_head) * D);
  const T* qb = q + ((int64_t)b * h + (int64_t)kv_head * g) * D;

  for (int e = tid; e < g * D; e += kThreads) qf[e] = to_float(qb[e]);
  for (int e = tid; e < g * D; e += kThreads) acc[e] = 0.0f;
  for (int e = tid; e < g; e += kThreads) {
    m_g[e] = kNegInf;
    l_g[e] = 0.0f;
  }

  for (int j0 = first; j0 < last; j0 += kBKV) {
    const int n = min(kBKV, last - j0);
    __syncthreads();  // previous tile consumed (and the set-up above)
    for (int e = tid; e < n * L::words; e += kThreads) {
      const int r = e / L::words;
      const int w = e - r * L::words;
      const int64_t off = (int64_t)(j0 + r) * row_words + w;
      kt[r * L::ldk + w] = kb[off];
      vt[r * L::ldv + w] = vb[off];
    }
    __syncthreads();
    // scores: (head of the group, position) pairs over the threads
    for (int e = tid; e < g * kBKV; e += kThreads) {
      const int gi = e / kBKV;
      const int j = e - gi * kBKV;
      s[e] = j < n ? dot_row<T, D>(qf + gi * D, kt + j * L::ldk) * sm_scale
                   : 0.0f;
    }
    __syncthreads();
    // online softmax, a warp per head of the group
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float x[2];
      bool in[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = lane + 32 * t;
        in[t] = j < n;
        x[t] = s[gi * kBKV + j];
      }
      const float mx = warp_max(fmaxf(in[0] ? x[0] : -INFINITY,
                                      in[1] ? x[1] : -INFINITY));
      const float m_prev = m_g[gi];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = in[0] ? expf(x[0] - m_new) : 0.0f;
      const float p1 = in[1] ? expf(x[1] - m_new) : 0.0f;
      const float sum = warp_sum(p0 + p1);
      const float alpha = expf(m_prev - m_new);
      // p rounded to the value dtype before P.V (flash.py:182)
      s[gi * kBKV + lane] = to_float(from_float<T>(p0));
      s[gi * kBKV + lane + 32] = to_float(from_float<T>(p1));
      __syncwarp();
      if (lane == 0) {
        m_g[gi] = m_new;
        l_g[gi] = alpha * l_g[gi] + sum;
        alpha_g[gi] = alpha;
      }
    }
    __syncthreads();
    // acc = acc * alpha + P.V over (head of the group, d) pairs
    for (int e = tid; e < g * D; e += kThreads) {
      const int gi = e / D;
      const int d = e - gi * D;
      const float* pg = s + gi * kBKV;
      float a = acc[e] * alpha_g[gi];
      for (int j = 0; j < n; ++j) {
        a = fmaf(pg[j], row_elem(vt + j * L::ldv, d,
                                 static_cast<const T*>(nullptr)),
                 a);
      }
      acc[e] = a;
    }
  }
  __syncthreads();
  for (int e = tid; e < g * D; e += kThreads) {
    const int gi = e / D;
    const int d = e - gi * D;
    const int64_t bh = (int64_t)b * h + kv_head * g + gi;
    part_acc[(bh * n_chunks + c) * D + d] = acc[e];
    if (d == 0) {
      part_ml[(bh * n_chunks + c) * 2] = m_g[gi];
      part_ml[(bh * n_chunks + c) * 2 + 1] = l_g[gi];
    }
  }
}

// Pass 2: one block per (batch, head), a thread per d.
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_ml,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ out, int n_chunks,
                                          int d) {
  const int64_t bh = blockIdx.x;
  const float* ml = part_ml + bh * n_chunks * 2;
  float m = kNegInf;
  for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, ml[2 * c]);
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float l = 0.0f;
    float acc = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const float w = expf(ml[2 * c] - m);
      l = fmaf(ml[2 * c + 1], w, l);
      acc = fmaf(part_acc[(bh * n_chunks + c) * d + i], w, acc);
    }
    out[bh * d + i] = from_float<T>(acc / (l == 0.0f ? 1.0f : l));
  }
}

template <typename T, int D>
int launch_flash_decode(const void* q, const void* k, const void* v,
                        float* part_ml, float* part_acc, void* out, int b,
                        int smax, int h, int kvh, int pos, int chunk,
                        float sm_scale, cudaStream_t stream) {
  using L = K7Layout<T, D>;
  auto kernel = flash_decode_partial_kernel<T, D>;
  const size_t bytes = L::bytes(h / kvh);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int n_chunks = (pos + chunk) / chunk;  // chunks holding 0..pos
  dim3 grid(n_chunks, kvh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), part_ml, part_acc, smax, h, kvh, pos, chunk,
      sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_decode_merge_kernel<T><<<b * h, D, 0, stream>>>(
      part_ml, part_acc, static_cast<T*>(out), n_chunks, D);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_flash_decode(int d, const void* q, const void* k, const void* v,
                          float* part_ml, float* part_acc, void* out, int b,
                          int smax, int h, int kvh, int pos, int chunk,
                          float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_flash_decode<T, 32>(q, k, v, part_ml, part_acc, out, b,
                                        smax, h, kvh, pos, chunk, sm_scale,
                                        stream);
    case 64:
      return launch_flash_decode<T, 64>(q, k, v, part_ml, part_acc, out, b,
                                        smax, h, kvh, pos, chunk, sm_scale,
                                        stream);
    case 128:
      return launch_flash_decode<T, 128>(q, k, v, part_ml, part_acc, out, b,
                                         smax, h, kvh, pos, chunk, sm_scale,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points launch on `stream`, never synchronise, allocate nothing
// and return a CUDA error code (0 on success).  `bf16`: 1 bfloat16, 0
// float32 (q, k, v and out share the type).

// K6.  seg: (B, S) int32 segment ids or null.
extern "C" int tangram_flash_attention(const void* q, const void* k,
                                       const void* v, const int* seg,
                                       void* out, int b, int sq, int skv,
                                       int h, int kvh, int d, int causal,
                                       float sm_scale, int bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch_flash_attention<32>(bf16, q, k, v, seg, out, b, sq, skv,
                                        h, kvh, causal, sm_scale, s);
    case 64:
      return launch_flash_attention<64>(bf16, q, k, v, seg, out, b, sq, skv,
                                        h, kvh, causal, sm_scale, s);
    case 128:
      return launch_flash_attention<128>(bf16, q, k, v, seg, out, b, sq, skv,
                                         h, kvh, causal, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K7.  part_ml (B, H, n_chunks, 2) and part_acc (B, H, n_chunks, D) float32
// scratch, n_chunks = pos / chunk + 1; chunk a multiple of 64.
extern "C" int tangram_flash_decode(const void* q, const void* k,
                                    const void* v, void* part_ml,
                                    void* part_acc, void* out, int b,
                                    int smax, int h, int kvh, int d, int pos,
                                    int chunk, float sm_scale, int bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  if (bf16) {
    return dispatch_flash_decode<__nv_bfloat16>(d, q, k, v, ml, acc, out, b,
                                                smax, h, kvh, pos, chunk,
                                                sm_scale, s);
  }
  return dispatch_flash_decode<float>(d, q, k, v, ml, acc, out, b, smax, h,
                                      kvh, pos, chunk, sm_scale, s);
}
