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
// an SM.  Other head dims: below.  Each step waits for its own
// products, so a consumer's tensor work and its softmax (64 exp2 a thread
// a tile on the special-function unit) alternate, and only the other
// consumer fills the gaps.  Later work: explicit ping-pong of the two
// consumers on named barriers and, with it, overlapping a tile's softmax
// with its own products (issuing the previous tile's P.V behind this
// tile's Q.K^T alone ran slower on the card); the causal diagonal tile
// is computed whole and masked, and the first consumer computes tiles its
// rows never see; the output is stored from registers (4-byte stores),
// not through TMA.  float32 inputs take an FMA kernel on the CUDA cores
// (TF32 would miss the 1e-4 tolerance): one block per (64 query rows,
// head, batch), 4 warps of 16 rows, the score and output tiles in shared
// memory, off the main path.
//
// K6 at the other head dims.  The Pallas kernel's blocks span the full
// head dim (flash.py:129-131), so it takes any D: DiT-XL/2 has 16 heads of
// 72, the reduced configs heads of 16.  bf16 at a d outside {32, 64, 128}
// runs the same wgmma kernel on a padded layout: Q, K and V are laid out
// at Dp = d rounded up to 16 (80 for 72), in Dp / 16 column blocks of 16
// (rows x 32 bytes, 32-byte swizzled, which spreads the eight rows of a
// 16-byte column over eight bank groups as the wider swizzles do).  The
// tensor maps' innermost dim is the real d with a box of 16 columns, so
// TMA writes the columns past d as zeros and reads no byte past d; they
// add nothing to a score and the output stores only d columns, rows d
// apart.  Q.K^T takes Dp / 16 k-steps, one column block each; P.V one
// m64nDpk16 wgmma a k-step, V MN-major with its column blocks a tile's
// height apart.  Shared memory at Dp = 80: 100 KB.  The pad adds Dp / d of
// tensor work (11% at 72: 343 GFLOP at DiT-XL/2's gen_1024, B = 4,
// S = 4096, H = 16, non-causal, against a 309 GFLOP bound, 0.31 ms at
// 989 TFLOP/s).  float32 at any D runs the FMA kernel at Dp.
//
// K7 bound on an H100: bytes.  A step reads the cache up to pos once,
// 2*B*(pos+1)*Kv*D*sizeof(T): 33.6 MB at B = 2, pos = 4095 (0.010 ms at
// 3.35 TB/s), 1.07 GB at B = 8, pos = 32767 (0.321 ms); about 1.5 FMA a
// cache byte at G = 3.  Design.  The TPU grid (B*Kv, KV blocks) runs its
// KV axis in order; at B = 2 that is 16 (batch, KV head) pairs, 16 of 132
// SMs.  So K7 splits the positions 0..pos into chunks of a multiple of
// 64, one block per (chunk, KV head and group of up to 16 of its query
// heads, batch), and the chunks of one (batch, KV head, group), at most 8,
// are one thread-block cluster.  `pos` is a host int or an int32 on the
// device (`pos_ptr`), as the Pallas kernel reads it from SMEM, so one
// launch, captured in a CUDA graph, serves every position: the grid and
// the cluster are fixed by Smax, B, Kv and the SM count, and each block
// derives its chunk from the `pos` it reads (decode_chunk).  Blocks past
// pos hold the empty state (m = -1e30, l = 0, finite, so the merge weighs
// them 0) and still meet both cluster barriers.
// In a block of 4 warps each warp owns every fourth 16-position tile of
// the chunk and streams its tiles' K and V rows through a ring of its own
// (3 stages, 16-byte cp.async.cg copies, 8 KB a stage at D = 128 bf16),
// so two stages are in flight while it computes on the third and no warp
// waits on another until the chunk is done.  cp.async rather than TMA: a
// row of one KV head is D*2 contiguous bytes with rows Kv*D*2 apart, which
// 16-byte copies read coalesced with no tensor map to encode on the host
// for each of the 9,216 calls of a decode run.  A warp computes on the
// tensor cores (mma.sync m16n8k16, bf16 in, float32 out): the block's query
// heads are the 16 rows of A (q as registers, rows past G zero), so scores
// and P.V need no cross-lane dot-product reductions; ldmatrix reads the K
// and V rows through a 16-byte-chunk XOR swizzle without bank conflicts.
// The work is bound by bytes, far below the tensor cores' rate even with
// 13 of 16 rows idle at G = 3, so mma.sync (not wgmma) is for the
// registers and instructions it saves.  The online softmax runs on the
// score fragments in registers (masked positions past `last` are not
// scores: p = 0, out of the max); p is rounded to bf16 as the A fragment
// of P.V.  Each warp keeps its own (m, l, acc); the block merges its warps'
// states into a shared-memory slot, and after cluster.sync() rank 0 reads
// every rank's slot through distributed shared memory, merges them in
// chunk order (M = max m_c, l = sum l_c 2^(m_c - M), acc likewise), writes
// acc / l (l = 0 -> 1), and a second cluster.sync() keeps the peers'
// slots alive until then: one launch a call, no global scratch.  float32
// takes the same ring, layout and merge on the CUDA cores (off the main
// path).
//
// Contract (checked by the wrappers in flash.py): contiguous tensors on one
// device, 16-byte aligned; K6: D a multiple of 8 up to 128 (bf16 on wgmma,
// padded to a multiple of 16 outside 32, 64, 128; float32 on the FMA kernel),
// causal or segment ids need Sq == Skv; K7: D in {32, 64, 128}, a host
// pos in [0, Smax); a device pos is clamped into [0, Smax) by the kernel
// (no read leaves the cache; XLA's dynamic_update_slice clamps its start
// the same way).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;  // the finite mask value of flash.py:30
constexpr int kThreads = 128;      // 4 warps (float32 K6)
constexpr int kBQ = 64;            // float32 K6 query rows per block
constexpr int kBKV = 64;           // float32 K6 positions per KV tile
constexpr int kRowsPerWarp = 16;

__host__ __device__ constexpr size_t round_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
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
// base): Q, then the K stages, then the V stages, then the barriers.  D is
// the head dim as laid out; each tile is D / kCols column blocks of (rows x
// kSw bytes), kSw-byte swizzled: 128 at d = 64 and 128, 64 at d = 32, and
// 32 (16-column blocks) at every other d, which is laid out at D = d
// rounded up to 16 with the columns past d zero-filled by TMA.
template <int D, int kSw>
struct WgLayout {
  static constexpr int kCols = kSw / 2;                   // bf16 a block
  static constexpr int kBlocks = D / kCols;
  static_assert(D % kCols == 0, "whole column blocks");
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
  } else if constexpr (D == 112) {
    hopper::wgmma_rs_n112<1>(o, a, b, 1);
  } else if constexpr (D == 96) {
    hopper::wgmma_rs_n96<1>(o, a, b, 1);
  } else if constexpr (D == 80) {
    hopper::wgmma_rs_n80<1>(o, a, b, 1);
  } else if constexpr (D == 64) {
    hopper::wgmma_rs_n64<1>(o, a, b, 1);
  } else if constexpr (D == 48) {
    hopper::wgmma_rs_n48<1>(o, a, b, 1);
  } else if constexpr (D == 32) {
    hopper::wgmma_rs_n32<1>(o, a, b, 1);
  } else {
    static_assert(D == 16, "D a multiple of 16 up to 128");
    hopper::wgmma_rs_n16<1>(o, a, b, 1);
  }
}

template <int D, int kSw>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             const int* __restrict__ seg,
                             __nv_bfloat16* __restrict__ out, int sq, int skv,
                             int h, int kvh, int d, int causal,
                             float scale_log2) {
  using L = WgLayout<D, kSw>;
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
            qs + c * L::q_block + wg * 64 * kSw + off, 16, 8 * kSw, kSw);
        const uint64_t db = hopper::smem_desc(kt + c * L::kv_block + off, 16,
                                              8 * kSw, kSw);
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

      // O += P . V, V MN-major: 16 positions a k-step, one m64nDk16 over
      // the D / kCols column blocks kv_block apart
      const unsigned char* vt = vs + st * L::kv_bytes;
      hopper::wgmma_fence();
      hopper::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kWgBKV / 16; ++kk) {
        const uint64_t db = hopper::smem_desc(vt + kk * 16 * kSw,
                                              L::kv_block, 8 * kSw, kSw);
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
    // rows of d columns; the padded layout's columns past d (zeros in V,
    // so zeros here) are not stored.  d is a multiple of 8, so a pair of
    // columns is all in or all out.
    const int ld = kSw == 32 ? d : D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int row = (i & 2) ? row_b : row_a;
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      if (row >= sq || col >= ld) continue;
      const float safe = (i & 2) ? safe_b : safe_a;
      *reinterpret_cast<__nv_bfloat162*>(
          out + (((int64_t)b * sq + row) * h + head) * ld + col) =
          __floats2bfloat162_rn(o[i] / safe, o[i + 1] / safe);
    }
  }
}

// The (B, S, heads, d) bf16 tensor as a 4-D TMA map whose box is (one
// column block of kCols, one head, `rows` positions, one batch).  The map's
// innermost dim is the real d (rows d * 2 bytes apart, a multiple of 16 as
// TMA needs), so a box's columns past d come in as zeros and no byte past
// d is read.
template <int kSw>
int encode_qkv_map(CUtensorMap* map, const void* base, int b, int s,
                   int heads, int d, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads,
                              (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)s * heads * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kSw / 2, 1, (cuuint32_t)rows, 1};
  return hopper::encode_bf16_map(map, base, 4, dims, strides, box, kSw);
}

template <int D, int kSw>
int launch_flash_attention_wgmma(const void* q, const void* k, const void* v,
                                 const int* seg, void* out, int b, int sq,
                                 int skv, int h, int kvh, int d, int causal,
                                 float sm_scale, cudaStream_t stream) {
  using L = WgLayout<D, kSw>;
  CUtensorMap qmap, kmap, vmap;
  int rc = encode_qkv_map<kSw>(&qmap, q, b, sq, h, d, kWgBQ);
  if (rc == 0) rc = encode_qkv_map<kSw>(&kmap, k, b, skv, kvh, d, kWgBKV);
  if (rc == 0) rc = encode_qkv_map<kSw>(&vmap, v, b, skv, kvh, d, kWgBKV);
  if (rc != 0) return rc;
  auto kernel = flash_attention_wgmma_kernel<D, kSw>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kWgBQ - 1) / kWgBQ, h, b);
  kernel<<<grid, kWgThreads, L::bytes, stream>>>(
      qmap, kmap, vmap, seg, static_cast<__nv_bfloat16*>(out), sq, skv, h,
      kvh, d, causal, sm_scale * kLog2e);
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
// src + r * stride, into a tile of D columns with row stride ld: the d
// columns of a row, zeros past them and past `limit`.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int first, int limit, int d) {
  for (int e = threadIdx.x; e < kBQ * D; e += kThreads) {
    const int r = e / D;
    const int c = e - r * D;
    dst[r * ld + c] = first + r < limit && c < d
                          ? src[(first + r) * stride + c]
                          : 0.0f;
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

// D: the head dim d rounded up to 16; the columns past d are zeros, which
// add nothing to the scores, and are not stored.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int* __restrict__ seg,
                           float* __restrict__ out, int sq, int skv, int h,
                           int kvh, int d, int causal, float sm_scale) {
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
  const int64_t q_stride = (int64_t)h * d;
  const int64_t kv_stride = (int64_t)kvh * d;
  const float* qb = q + ((int64_t)b * sq * h + head) * d;
  const float* kb = k + ((int64_t)b * skv * kvh + kv_head) * d;
  const float* vb = v + ((int64_t)b * skv * kvh + kv_head) * d;
  const int use_seg = seg != nullptr;

  load_tile<D>(qs, L::ldt, qb, q_stride, q0, sq, d);
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
    load_tile<D>(ks, L::ldt, kb, kv_stride, j0, skv, d);
    load_tile<D>(vs, L::ldt, vb, kv_stride, j0, skv, d);
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
    float* dst = out + (((int64_t)b * sq + qi) * h + head) * d;
    for (int c = lane; c < d; c += 32) dst[c] = o[r * L::ldo + c] / safe;
  }
}

template <int D>
int launch_flash_attention_fma(const void* q, const void* k, const void* v,
                               const int* seg, void* out, int b, int sq,
                               int skv, int h, int kvh, int d, int causal,
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
      h, kvh, d, causal, sm_scale);
  return (int)cudaGetLastError();
}

// K6 at a head dim d laid out at D = d rounded up to 16, zeros past d:
// the wgmma kernel on 32-byte swizzled column blocks (bf16) or the FMA
// kernel (float32).
template <int D>
int launch_flash_attention_padded(int bf16, const void* q, const void* k,
                                  const void* v, const int* seg, void* out,
                                  int b, int sq, int skv, int h, int kvh,
                                  int d, int causal, float sm_scale,
                                  cudaStream_t stream) {
  if (bf16) {
    return launch_flash_attention_wgmma<D, 32>(q, k, v, seg, out, b, sq, skv,
                                               h, kvh, d, causal, sm_scale,
                                               stream);
  }
  return launch_flash_attention_fma<D>(q, k, v, seg, out, b, sq, skv, h, kvh,
                                       d, causal, sm_scale, stream);
}

// ------------------------------------- cp.async, ldmatrix, mma.sync (K7) ----

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(row))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_addr(row))
      : "memory");
}

// c (16 x 8 f32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16), the
// fragments of mma.sync m16n8k16: thread t holds rows t/4 and t/4 + 8 of a
// and c, columns 2 (t % 4) (+ 1) of c, k 2 (t % 4) (+ 1, + 8, + 9).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------------------ K7 ----

constexpr int kDecWarps = 4;    // warps a block, each with its own ring
constexpr int kDecTile = 16;    // positions a warp's ring stage holds
constexpr int kDecStages = 3;   // stages of a warp's ring
constexpr int kDecHeads = 16;   // query heads a block (the mma's 16 rows)

// Shared memory of one K7 block.  Warp w owns bytes [w, w + 1) * warp_bytes
// of the ring: kDecStages stages of a K tile then a V tile, kDecTile rows of
// D elements each, every row's 16-byte chunks swizzled (decode_chunk_at) so
// that eight rows read at one column hit eight different bank groups.  When
// its tiles are done a warp writes its (m, l, acc) state over its own ring;
// the block's merged state (the slot the cluster's rank 0 reads) follows
// the ring.  float32 blocks also keep q and a score tile per warp.
template <typename T, int D>
struct DecLayout {
  static constexpr int row_bytes = D * (int)sizeof(T);
  static constexpr int chunks = row_bytes / 16;   // 16-byte chunks a row
  static constexpr int tile_bytes = kDecTile * row_bytes;
  static constexpr int stage_bytes = 2 * tile_bytes;   // K then V
  static constexpr int warp_bytes = kDecStages * stage_bytes;
  // a state: acc (kDecHeads, D) f32, then m and l (kDecHeads) f32
  static constexpr int state_bytes = (kDecHeads * D + 2 * kDecHeads) * 4;
  static constexpr int slot_off = kDecWarps * warp_bytes;
  static constexpr int q_off = slot_off + state_bytes;
  static constexpr int s_off = q_off + kDecHeads * D * 4;
  static constexpr bool f32 = std::is_same<T, float>::value;
  static constexpr int bytes =
      f32 ? s_off + kDecWarps * kDecHeads * kDecTile * 4 : q_off;
  static_assert(state_bytes <= warp_bytes, "a warp's state fits its ring");
};

// The physical 16-byte chunk of chunk c in row r: XOR-swizzled within each
// 128-byte line (rows of 64 bytes pair up in a line).
template <int C>
__device__ __forceinline__ int decode_chunk_at(int r, int c) {
  if constexpr (C >= 8) {
    return c ^ (r & 7);
  } else {
    return c ^ ((r >> 1) & (C - 1));
  }
}

// Positions a block takes at `pos` with `n_chunks` chunks a (batch, KV
// head, group): the block passes of 0..pos spread evenly, in whole passes
// (flash.py's decode_chunk mirrors it).  Chunk c holds [c * chunk,
// min((c + 1) * chunk, pos + 1)), empty past pos.
__device__ __forceinline__ int decode_chunk(int pos, int n_chunks) {
  constexpr int per_pass = kDecWarps * kDecTile;
  const int passes = pos / per_pass + 1;
  return (passes + n_chunks - 1) / n_chunks * per_pass;
}

// Everything one K7 block reads: where its KV head's rows start, which
// positions are its chunk's, which query heads are its own.
template <typename T>
struct DecBlock {
  const T* k;        // the KV head's row 0 in k (rows kvh * D apart)
  const T* v;
  int64_t stride;    // elements between positions
  int first, last;   // positions [first, last) of the chunk
  int gh;            // query heads of the block (<= kDecHeads)
  const T* q;        // the block's first query head, (gh, D) contiguous
  T* out;            // the same heads in out
};

// One warp's ring: copy the K and V rows of positions j0 .. j0 + 15 (zeros
// past `last`, which are never read) into `stage`, one commit group.
template <typename T, int D>
__device__ __forceinline__ void load_stage(unsigned char* stage,
                                           const DecBlock<T>& blk, int j0,
                                           int lane) {
  using L = DecLayout<T, D>;
  constexpr int per_tile = kDecTile * L::chunks;
#pragma unroll
  for (int e = lane; e < 2 * per_tile; e += 32) {
    const int is_v = e >= per_tile;
    const int rc = e - is_v * per_tile;
    const int r = rc / L::chunks;
    const int c = rc - r * L::chunks;
    const int j = j0 + r;
    const int valid = j < blk.last;
    const T* src = (is_v ? blk.v : blk.k) +
                   (int64_t)(valid ? j : blk.first) * blk.stride +
                   c * (16 / (int)sizeof(T));
    cp_async_16(stage + is_v * L::tile_bytes + r * L::row_bytes +
                    decode_chunk_at<L::chunks>(r, c) * 16,
                src, valid ? 16 : 0);
  }
  cp_async_commit();
}

// A warp's online-softmax state over its tiles, and how it streams them:
// the warp owns tiles w, w + kDecWarps, ... of 16 positions, keeps
// kDecStages - 1 of them in flight while it computes on one, and waits on
// nothing but its own copies.
template <typename T, int D, typename Tile>
__device__ __forceinline__ void stream_tiles(unsigned char* ring,
                                             const DecBlock<T>& blk, int warp,
                                             int lane, Tile&& tile) {
  using L = DecLayout<T, D>;
  const int n_tiles = (blk.last - blk.first + kDecTile - 1) / kDecTile;
  const int mine = warp < n_tiles ? (n_tiles - warp + kDecWarps - 1) /
                                        kDecWarps
                                  : 0;
  auto j0_of = [&](int i) {
    return blk.first + (warp + i * kDecWarps) * kDecTile;
  };
#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (i < mine) {
      load_stage<T, D>(ring + i * L::stage_bytes, blk, j0_of(i), lane);
    } else {
      cp_async_commit();   // empty group: the wait below counts groups
    }
  }
  for (int i = 0; i < mine; ++i) {
    const int ahead = i + kDecStages - 1;
    if (ahead < mine) {
      load_stage<T, D>(ring + (ahead % kDecStages) * L::stage_bytes, blk,
                       j0_of(ahead), lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kDecStages - 1>();   // tile i has landed (this lane's)
    __syncwarp();                      // ... and every lane's
    tile(ring + (i % kDecStages) * L::stage_bytes, j0_of(i));
    __syncwarp();   // the stage is free for the copy issued next
  }
  cp_async_wait<0>();
  __syncwarp();
}

// bf16: scores and P.V on the tensor cores (mma.sync m16n8k16, rows = the
// block's query heads, padded to 16), the online softmax on the score
// fragments in registers.  Returns the warp's state in its ring.
template <int D>
__device__ __forceinline__ void decode_warp(unsigned char* ring,
                                            const DecBlock<__nv_bfloat16>& blk,
                                            int warp, int lane,
                                            float scale_log2) {
  using T = __nv_bfloat16;
  using L = DecLayout<T, D>;
  const int ga = lane / 4, gb = ga + 8;   // this thread's two rows
  const int quad = lane % 4;
  // q as the A fragments of the D / 16 k-steps, zero rows past gh
  uint32_t qa[D / 16][4];
  const uint32_t* qa_row = reinterpret_cast<const uint32_t*>(blk.q + ga * D);
  const uint32_t* qb_row = reinterpret_cast<const uint32_t*>(blk.q + gb * D);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int w = kk * 8 + quad;   // a bf16 pair
    qa[kk][0] = ga < blk.gh ? qa_row[w] : 0u;
    qa[kk][1] = gb < blk.gh ? qb_row[w] : 0u;
    qa[kk][2] = ga < blk.gh ? qa_row[w + 4] : 0u;
    qa[kk][3] = gb < blk.gh ? qb_row[w + 4] : 0u;
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.0f, l_b = 0.0f;
  // ldmatrix rows this lane addresses: matrix lane / 8, its row lane % 8
  const int mat = lane / 8, mrow = lane % 8;

  stream_tiles<T, D>(ring, blk, warp, lane, [&](unsigned char* st, int j0) {
    const unsigned char* kt = st;
    const unsigned char* vt = st + L::tile_bytes;
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    // S = q . K^T: matrices (positions 0-7 | 8-15) x (dims lo | hi)
    const int kr = (mat / 2) * 8 + mrow;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + kr * L::row_bytes +
                         decode_chunk_at<L::chunks>(kr, 2 * kk + mat % 2) * 16);
      mma_bf16(s[0], qa[kk], b[0], b[1]);
      mma_bf16(s[1], qa[kk], b[2], b[3]);
    }
    // mask past `last`, scale to base 2, row max over the quad
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + 2 * quad + (e & 1);
        const float x = j < blk.last ? s[n][e] * scale_log2 : -INFINITY;
        s[n][e] = x;
        if (e < 2) {
          mx_a = fmaxf(mx_a, x);
        } else {
          mx_b = fmaxf(mx_b, x);
        }
      }
    }
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 1));
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, 2));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 1));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, 2));
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = fast_exp2(m_a - mn_a);
    const float alpha_b = fast_exp2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[n][e] - (e < 2 ? mn_a : mn_b));
        s[n][e] = p;
        if (e < 2) {
          sum_a += p;
        } else {
          sum_b += p;
        }
      }
    }
    // each thread keeps its share of l; the quad sums it at the end
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
    // p rounded to bf16 (flash.py:182): the score fragments of positions
    // 0-7 and 8-15 are the A fragment of the P.V k-step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
    // O = O * alpha + P . V: matrices (positions 0-7 | 8-15) x (dims
    // n | n + 8), transposed
    const int vr = (mat % 2) * 8 + mrow;
#pragma unroll
    for (int n = 0; n < D / 8; n += 2) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
      o[n + 1][0] *= alpha_a;
      o[n + 1][1] *= alpha_a;
      o[n + 1][2] *= alpha_b;
      o[n + 1][3] *= alpha_b;
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + vr * L::row_bytes +
                               decode_chunk_at<L::chunks>(vr, n + mat / 2) *
                                   16);
      mma_bf16(o[n], pa, b[0], b[1]);
      mma_bf16(o[n + 1], pa, b[2], b[3]);
    }
  });

  l_a += __shfl_xor_sync(0xffffffffu, l_a, 1);
  l_a += __shfl_xor_sync(0xffffffffu, l_a, 2);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 1);
  l_b += __shfl_xor_sync(0xffffffffu, l_b, 2);
  float* acc = reinterpret_cast<float*>(ring);
  float* ml = acc + kDecHeads * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int d = n * 8 + 2 * quad;
    acc[ga * D + d] = o[n][0];
    acc[ga * D + d + 1] = o[n][1];
    acc[gb * D + d] = o[n][2];
    acc[gb * D + d + 1] = o[n][3];
  }
  if (quad == 0) {
    ml[ga] = m_a;
    ml[gb] = m_b;
    ml[kDecHeads + ga] = l_a;
    ml[kDecHeads + gb] = l_b;
  }
}

// float32 (off the main path): the same ring and state on the CUDA cores.
// Lanes take (head, position) pairs for the scores, lane g runs row g's
// online softmax, and lane l owns dims l, l + 32, ... of the output.
template <int D>
__device__ __forceinline__ void decode_warp(unsigned char* ring,
                                            const DecBlock<float>& blk,
                                            int warp, int lane,
                                            float scale_log2) {
  using L = DecLayout<float, D>;
  unsigned char* smem = ring - warp * L::warp_bytes;
  const float* qs = reinterpret_cast<const float*>(smem + L::q_off);
  float* sc = reinterpret_cast<float*>(smem + L::s_off) +
              warp * kDecHeads * kDecTile;
  float acc[kDecHeads][D / 32];
#pragma unroll
  for (int g = 0; g < kDecHeads; ++g) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[g][i] = 0.0f;
  }
  float m = kNegInf, l = 0.0f;   // row `lane`'s, for lane < gh

  stream_tiles<float, D>(ring, blk, warp, lane, [&](unsigned char* st,
                                                    int j0) {
    const unsigned char* kt = st;
    const unsigned char* vt = st + L::tile_bytes;
    for (int e = lane; e < blk.gh * kDecTile; e += 32) {
      const int g = e / kDecTile;
      const int j = e - g * kDecTile;
      float dot = 0.0f;
#pragma unroll 4
      for (int c = 0; c < L::chunks; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(
            kt + j * L::row_bytes + decode_chunk_at<L::chunks>(j, c) * 16);
        const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + 4 * c);
        dot = fmaf(qv.x, kv.x, dot);
        dot = fmaf(qv.y, kv.y, dot);
        dot = fmaf(qv.z, kv.z, dot);
        dot = fmaf(qv.w, kv.w, dot);
      }
      sc[e] = j0 + j < blk.last ? dot * scale_log2 : -INFINITY;
    }
    __syncwarp();
    float alpha = 1.0f;
    if (lane < blk.gh) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kDecTile; ++j) mx = fmaxf(mx, sc[lane * kDecTile + j]);
      const float mn = fmaxf(m, mx);
      alpha = fast_exp2(m - mn);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kDecTile; ++j) {
        const float p = fast_exp2(sc[lane * kDecTile + j] - mn);
        sc[lane * kDecTile + j] = p;
        sum += p;
      }
      m = mn;
      l = l * alpha + sum;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < kDecHeads; ++g) {
      const float a_g = __shfl_sync(0xffffffffu, alpha, g);
      if (g < blk.gh) {
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const int d = lane + 32 * i;
          float a = acc[g][i] * a_g;
#pragma unroll
          for (int j = 0; j < kDecTile; ++j) {
            const float vv = *reinterpret_cast<const float*>(
                vt + j * L::row_bytes +
                decode_chunk_at<L::chunks>(j, d / 4) * 16 + (d % 4) * 4);
            a = fmaf(sc[g * kDecTile + j], vv, a);
          }
          acc[g][i] = a;
        }
      }
    }
  });

  float* st_acc = reinterpret_cast<float*>(ring);
  float* ml = st_acc + kDecHeads * D;
#pragma unroll
  for (int g = 0; g < kDecHeads; ++g) {
#pragma unroll
    for (int i = 0; i < D / 32; ++i) st_acc[g * D + lane + 32 * i] = acc[g][i];
  }
  if (lane < kDecHeads) {
    ml[lane] = m;
    ml[kDecHeads + lane] = l;
  }
}

// Merge states in order: M = max m_i, l = sum l_i 2^(m_i - M),
// acc = sum acc_i 2^(m_i - M); state i at states[i] (acc, then m, then l).
template <int D>
__device__ __forceinline__ void merge_states(const float* const* states,
                                             int n, int g, int d,
                                             float* acc_out, float* m_out,
                                             float* l_out) {
  float big = kNegInf;
  for (int i = 0; i < n; ++i) big = fmaxf(big, states[i][kDecHeads * D + g]);
  float l = 0.0f, acc = 0.0f;
  for (int i = 0; i < n; ++i) {
    const float w = fast_exp2(states[i][kDecHeads * D + g] - big);
    l = fmaf(states[i][kDecHeads * D + kDecHeads + g], w, l);
    acc = fmaf(states[i][g * D + d], w, acc);
  }
  *acc_out = acc;
  *m_out = big;
  *l_out = l;
}

// One block per (chunk of positions, KV head and group of up to 16 of its
// query heads, batch); the chunks of one (batch, KV head, group) are one
// thread-block cluster.  Each warp streams its share of the chunk through
// its own ring; the block merges its warps' states into its slot; after
// cluster.sync() rank 0 reads every rank's slot through distributed shared
// memory, merges them in chunk order and writes the output.
template <typename T, int D>
__global__ void __launch_bounds__(kDecWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ out, int smax,
                    int h, int kvh, int groups,
                    const int32_t* __restrict__ pos_ptr, int pos_arg,
                    float scale_log2) {
  using L = DecLayout<T, D>;
  namespace cg = cooperative_groups;
  extern __shared__ __align__(128) unsigned char k7_smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g_all = h / kvh;
  const int kv_head = blockIdx.y / groups;
  const int g0 = (blockIdx.y - kv_head * groups) * kDecHeads;
  const int b = blockIdx.z;
  DecBlock<T> blk;
  blk.stride = (int64_t)kvh * D;
  blk.k = k + ((int64_t)b * smax * kvh + kv_head) * D;
  blk.v = v + ((int64_t)b * smax * kvh + kv_head) * D;
  // the position from the device when given, clamped into the cache
  const int pos =
      min(max(pos_ptr != nullptr ? *pos_ptr : pos_arg, 0), smax - 1);
  const int chunk = decode_chunk(pos, (int)gridDim.x);
  blk.first = blockIdx.x * chunk;
  blk.last = max(blk.first, min(blk.first + chunk, pos + 1));
  blk.gh = min(kDecHeads, g_all - g0);
  const int64_t head0 = (int64_t)b * h + (int64_t)kv_head * g_all + g0;
  blk.q = q + head0 * D;
  blk.out = out + head0 * D;

  if constexpr (L::f32) {
    float* qs = reinterpret_cast<float*>(k7_smem + L::q_off);
    for (int e = tid; e < kDecHeads * D; e += kDecWarps * 32) {
      qs[e] = e < blk.gh * D ? blk.q[e] : 0.0f;
    }
    __syncthreads();
  }
  unsigned char* ring = k7_smem + warp * L::warp_bytes;
  decode_warp<D>(ring, blk, warp, lane, scale_log2);
  __syncthreads();

  // the block's warps, merged in warp order, into the slot
  float* slot = reinterpret_cast<float*>(k7_smem + L::slot_off);
  const float* warps[kDecWarps];
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    warps[w] = reinterpret_cast<const float*>(k7_smem + w * L::warp_bytes);
  }
  for (int e = tid; e < blk.gh * D; e += kDecWarps * 32) {
    const int g = e / D, d = e - g * D;
    float m, l;
    merge_states<D>(warps, kDecWarps, g, d, &slot[e], &m, &l);
    if (d == 0) {
      slot[kDecHeads * D + g] = m;
      slot[kDecHeads * D + kDecHeads + g] = l;
    }
  }
  cluster.sync();   // every rank's slot is written

  if (cluster.block_rank() == 0) {
    const int n = (int)cluster.num_blocks();
    const float* ranks[8];
    for (int c = 0; c < n; ++c) ranks[c] = cluster.map_shared_rank(slot, c);
    for (int e = tid; e < blk.gh * D; e += kDecWarps * 32) {
      const int g = e / D, d = e - g * D;
      float acc, m, l;
      merge_states<D>(ranks, n, g, d, &acc, &m, &l);
      blk.out[e] = from_float<T>(acc / (l == 0.0f ? 1.0f : l));
    }
  }
  cluster.sync();   // peers' slots stay alive until rank 0 has read them
}

// The K7 instance's dynamic shared memory, allowed once per device.
template <typename T, int D>
cudaError_t allow_decode_smem() {
  static int set_on[64] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64) return err;
  if (!set_on[dev]) {
    err = cudaFuncSetAttribute(flash_decode_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               DecLayout<T, D>::bytes);
    if (err != cudaSuccess) return err;
    set_on[dev] = 1;
  }
  return cudaSuccess;
}

template <typename T, int D>
int launch_flash_decode(const void* q, const void* k, const void* v,
                        void* out, int b, int smax, int h, int kvh,
                        const int32_t* pos_ptr, int pos, int n_chunks,
                        float sm_scale, cudaStream_t stream) {
  using L = DecLayout<T, D>;
  auto kernel = flash_decode_kernel<T, D>;
  cudaError_t err = allow_decode_smem<T, D>();
  if (err != cudaSuccess) return (int)err;
  const int groups = (h / kvh + kDecHeads - 1) / kDecHeads;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, kvh * groups, b);
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = L::bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           static_cast<T*>(out), smax, h, kvh, groups,
                           pos_ptr, pos, sm_scale * kLog2e);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_flash_decode(int d, const void* q, const void* k, const void* v,
                          void* out, int b, int smax, int h, int kvh,
                          const int32_t* pos_ptr, int pos, int n_chunks,
                          float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_flash_decode<T, 32>(q, k, v, out, b, smax, h, kvh,
                                        pos_ptr, pos, n_chunks, sm_scale,
                                        stream);
    case 64:
      return launch_flash_decode<T, 64>(q, k, v, out, b, smax, h, kvh,
                                        pos_ptr, pos, n_chunks, sm_scale,
                                        stream);
    case 128:
      return launch_flash_decode<T, 128>(q, k, v, out, b, smax, h, kvh,
                                         pos_ptr, pos, n_chunks, sm_scale,
                                         stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points launch on `stream`, never synchronise, allocate nothing
// and return a CUDA error code (0 on success).  `bf16`: 1 bfloat16, 0
// float32 (q, k, v and out share the type).

// K6.  seg: (B, S) int32 segment ids or null.  d: a multiple of 8 up to
// 128.  bf16 takes the wgmma kernel: at 32, 64 and 128 on 64- or 128-byte
// swizzled column blocks, at any other d on 16-column, 32-byte swizzled
// blocks of d rounded up to 16.  float32 takes the FMA kernel at d rounded
// up to 16.
extern "C" int tangram_flash_attention(const void* q, const void* k,
                                       const void* v, const int* seg,
                                       void* out, int b, int sq, int skv,
                                       int h, int kvh, int d, int causal,
                                       float sm_scale, int bf16,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 0 || d > 128 || d % 8 != 0) return (int)cudaErrorInvalidValue;
  if (bf16) {
    switch (d) {
      case 32:
        return launch_flash_attention_wgmma<32, 64>(q, k, v, seg, out, b, sq,
                                                    skv, h, kvh, d, causal,
                                                    sm_scale, s);
      case 64:
        return launch_flash_attention_wgmma<64, 128>(q, k, v, seg, out, b,
                                                     sq, skv, h, kvh, d,
                                                     causal, sm_scale, s);
      case 128:
        return launch_flash_attention_wgmma<128, 128>(q, k, v, seg, out, b,
                                                      sq, skv, h, kvh, d,
                                                      causal, sm_scale, s);
      default:
        break;
    }
  }
  switch ((d + 15) / 16) {
    case 1:
      return launch_flash_attention_padded<16>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 2:
      return launch_flash_attention_padded<32>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 3:
      return launch_flash_attention_padded<48>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 4:
      return launch_flash_attention_padded<64>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 5:
      return launch_flash_attention_padded<80>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 6:
      return launch_flash_attention_padded<96>(bf16, q, k, v, seg, out, b, sq,
                                               skv, h, kvh, d, causal,
                                               sm_scale, s);
    case 7:
      return launch_flash_attention_padded<112>(bf16, q, k, v, seg, out, b,
                                                sq, skv, h, kvh, d, causal,
                                                sm_scale, s);
    default:
      return launch_flash_attention_padded<128>(bf16, q, k, v, seg, out, b,
                                                sq, skv, h, kvh, d, causal,
                                                sm_scale, s);
  }
}

// K7.  pos_ptr: one int32 on the device, read by every block, or null for
// the host `pos`.  n_chunks: chunks a (batch, KV head, group), 1 to 8 (one
// cluster), fixed by the caller for every pos.
extern "C" int tangram_flash_decode(const void* q, const void* k,
                                    const void* v, void* out, int b,
                                    int smax, int h, int kvh, int d,
                                    const int32_t* pos_ptr, int pos,
                                    int n_chunks, float sm_scale, int bf16,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks < 1 || n_chunks > 8 || smax < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16) {
    return dispatch_flash_decode<__nv_bfloat16>(d, q, k, v, out, b, smax, h,
                                                kvh, pos_ptr, pos, n_chunks,
                                                sm_scale, s);
  }
  return dispatch_flash_decode<float>(d, q, k, v, out, b, smax, h, kvh,
                                      pos_ptr, pos, n_chunks, sm_scale, s);
}
