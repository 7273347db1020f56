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
// scores at all: they get p = 0 and never enter the max.
//
// K6 bound on an H100: operations.  Causal attention does 2*B*S^2*H*D
// FLOP (the two products over the lower triangle), 206 GFLOP at B = 2,
// S = 4096, H = 24, D = 128: 0.208 ms at 989 TFLOP/s bf16, against 0.2 ms
// of bytes only if every input were read once.  Design.  The TPU kernel
// runs a sequential KV grid axis carrying (m, l, acc) in VMEM scratch; on
// Hopper blocks carry nothing between them, so one block per (query tile
// of 64 rows, query head, batch) loops over the KV tiles itself.  Each of
// its 4 warps owns 16 query rows: it multiplies Q.K^T for its rows on the
// tensor cores (WMMA 16x16x16 bf16, float32 accumulators) into a float32
// score tile in shared memory, runs the online softmax over its rows with
// warp shuffles, rescales its rows of the float32 output tile in shared
// memory by alpha and adds P.V on the tensor cores.  Only the K/V tile
// loads need the whole block.  Causal blocks stop at the diagonal tile
// (the TPU kernel's early-out), and the heaviest query tiles start first.
// At D = 128 the Q, K, V tiles (17 KB each), the score tile (17 KB), the
// P tile and the output tile take 111 KB of dynamic shared memory, past
// the 48 KB default, so the launch sets
// cudaFuncAttributeMaxDynamicSharedMemorySize; two blocks fit on an SM.
// float32 inputs take an FMA variant on the CUDA cores (TF32 would miss
// the 1e-4 tolerance).  wgmma, TMA, register-resident accumulators and a
// pipelined K/V ring are later work: this kernel sits well above its
// bound.
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
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the finite mask value of flash.py:30
constexpr int kThreads = 128;      // 4 warps
constexpr int kBQ = 64;            // K6 query rows per block (16 a warp)
constexpr int kBKV = 64;           // K6 / K7 positions per KV tile
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

// ------------------------------------------------------------------ K6 ----

// Shared-memory layout of one K6 block.  Row strides are padded: bf16 tiles
// by 8 elements (16-byte rows for vector stores, 32-byte aligned WMMA
// fragments every 16 rows), float32 tiles by 1 (the FMA variant reads one
// K row per lane: a stride of D + 1 words spreads the lanes over the banks).
template <typename T, int D>
struct K6Layout {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int ldt = kBf16 ? D + 8 : D + 1;      // Q, K, V
  static constexpr int lds = kBKV + 4;                   // scores (f32)
  static constexpr int ldp = kBf16 ? kBKV + 8 : kBKV + 4;  // P (T)
  static constexpr int ldo = D + 4;                      // output (f32)
  static constexpr size_t tile = round_up(sizeof(T) * kBQ * ldt, 128);
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + tile;
  static constexpr size_t v_off = k_off + tile;
  static constexpr size_t s_off = v_off + tile;
  static constexpr size_t p_off =
      s_off + round_up(sizeof(float) * kBQ * lds, 128);
  static constexpr size_t o_off = p_off + round_up(sizeof(T) * kBQ * ldp, 128);
  static constexpr size_t stat_off =
      o_off + round_up(sizeof(float) * kBQ * ldo, 128);
  // m, l, alpha (float) and the query / key segment ids (int)
  static constexpr size_t bytes = stat_off + 5 * kBQ * 4;
};

// Rows [first, first + 64) of a sequence whose row r starts at
// src + r * stride, into a tile with row stride ld; zero past `limit`.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int first,
                                          int limit, int d) {
  const int chunks = d / 8;  // 16-byte vectors per row
  for (int e = threadIdx.x; e < kBQ * chunks; e += kThreads) {
    const int r = e / chunks;
    const int c = (e - r * chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (first + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (first + r) * stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* src, int64_t stride,
                                          int first, int limit, int d) {
  for (int e = threadIdx.x; e < kBQ * d; e += kThreads) {
    const int r = e / d;
    const int c = e - r * d;
    dst[r * ld + c] = first + r < limit ? src[(first + r) * stride + c] : 0.0f;
  }
}

// S[rows of this warp][0, 64) = Q . K^T (unscaled), tensor cores.
template <int D>
__device__ __forceinline__ void tile_scores(const __nv_bfloat16* qs,
                                            const __nv_bfloat16* ks,
                                            float* s, int r0) {
  namespace wmma = nvcuda::wmma;
  using L = K6Layout<__nv_bfloat16, D>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBKV / 16];
#pragma unroll
  for (int j = 0; j < kBKV / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                   wmma::row_major>
        a;
    wmma::load_matrix_sync(a, qs + r0 * L::ldt + kk, L::ldt);
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      // K stored (position, d) row-major is K^T column-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major>
          b;
      wmma::load_matrix_sync(b, ks + (16 * j) * L::ldt + kk, L::ldt);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < kBKV / 16; ++j) {
    wmma::store_matrix_sync(s + r0 * L::lds + 16 * j, acc[j], L::lds,
                            wmma::mem_row_major);
  }
}

// The same with float32 FMAs: lane owns score columns lane and lane + 32.
template <int D>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks,
                                            float* s, int r0) {
  using L = K6Layout<float, D>;
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

// O[rows of this warp] += P . V, tensor cores (O already rescaled).
template <int D>
__device__ __forceinline__ void tile_pv(const __nv_bfloat16* p,
                                        const __nv_bfloat16* vs, float* o,
                                        int r0) {
  namespace wmma = nvcuda::wmma;
  using L = K6Layout<__nv_bfloat16, D>;
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      a[kBKV / 16];
#pragma unroll
  for (int j = 0; j < kBKV / 16; ++j) {
    wmma::load_matrix_sync(a[j], p + r0 * L::ldp + 16 * j, L::ldp);
  }
#pragma unroll
  for (int c = 0; c < D; c += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, o + r0 * L::ldo + c, L::ldo,
                           wmma::mem_row_major);
#pragma unroll
    for (int j = 0; j < kBKV / 16; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          b;
      wmma::load_matrix_sync(b, vs + (16 * j) * L::ldt + c, L::ldt);
      wmma::mma_sync(acc, a[j], b, acc);
    }
    wmma::store_matrix_sync(o + r0 * L::ldo + c, acc, L::ldo,
                            wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void tile_pv(const float* p, const float* vs,
                                        float* o, int r0) {
  using L = K6Layout<float, D>;
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ seg, T* __restrict__ out,
                       int sq, int skv, int h, int kvh, int causal,
                       float sm_scale) {
  using L = K6Layout<T, D>;
  extern __shared__ __align__(128) unsigned char k6_smem[];
  T* qs = reinterpret_cast<T*>(k6_smem + L::q_off);
  T* ks = reinterpret_cast<T*>(k6_smem + L::k_off);
  T* vs = reinterpret_cast<T*>(k6_smem + L::v_off);
  float* s = reinterpret_cast<float*>(k6_smem + L::s_off);
  T* p = reinterpret_cast<T*>(k6_smem + L::p_off);
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
  const T* qb = q + ((int64_t)b * sq * h + head) * D;
  const T* kb = k + ((int64_t)b * skv * kvh + kv_head) * D;
  const T* vb = v + ((int64_t)b * skv * kvh + kv_head) * D;
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
      p[r * L::ldp + lane] = from_float<T>(p0);
      p[r * L::ldp + lane + 32] = from_float<T>(p1);
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
    T* dst = out + (((int64_t)b * sq + qi) * h + head) * D;
    for (int c = lane; c < D; c += 32) {
      dst[c] = from_float<T>(o[r * L::ldo + c] / safe);
    }
  }
}

template <typename T, int D>
int launch_flash_attention(const void* q, const void* k, const void* v,
                           const int* seg, void* out, int b, int sq, int skv,
                           int h, int kvh, int causal, float sm_scale,
                           cudaStream_t stream) {
  using L = K6Layout<T, D>;
  auto kernel = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + kBQ - 1) / kBQ, h, b);
  kernel<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), seg, static_cast<T*>(out), sq, skv, h, kvh,
      causal, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_flash_attention(int d, const void* q, const void* k,
                             const void* v, const int* seg, void* out, int b,
                             int sq, int skv, int h, int kvh, int causal,
                             float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch_flash_attention<T, 32>(q, k, v, seg, out, b, sq, skv, h,
                                           kvh, causal, sm_scale, stream);
    case 64:
      return launch_flash_attention<T, 64>(q, k, v, seg, out, b, sq, skv, h,
                                           kvh, causal, sm_scale, stream);
    case 128:
      return launch_flash_attention<T, 128>(q, k, v, seg, out, b, sq, skv, h,
                                            kvh, causal, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
  if (bf16) {
    return dispatch_flash_attention<__nv_bfloat16>(
        d, q, k, v, seg, out, b, sq, skv, h, kvh, causal, sm_scale, s);
  }
  return dispatch_flash_attention<float>(d, q, k, v, seg, out, b, sq, skv, h,
                                         kvh, causal, sm_scale, s);
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
