// Fused stitch->patch-embed (K4) and decode->gather (K3) for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/stitch/fused_embed.py:
//   K4 stitch_embed_pallas    (:114) - patch slots -> embedded tokens; the
//                                      canvas batch never exists in memory
//   K3 unstitch_decode_pallas (:202) - raw head -> per-slot decoded grids
//
// Layouts (all row-major, contiguous):
//   slots   (P, hmax, wmax, C) float32
//   records (B, K, 6) int32 = (valid, slot, x, y, w, h)
//   kernel  (patch*patch*C, d) and bias (d,), float32 or bfloat16 (T)
//   tokens  (B, seq, d) T, seq = (M / patch) * (N / patch)
//   raw     (B, side_m, side_n, 5) T;  grids (num_slots, side_m, side_n, 5) f32
//
// K4 computes tokens = round_T(round_T(patchify(stitch(slots))) @ kernel
// + bias): each stitched f32 pixel is rounded to T (round to nearest even,
// as `.to(bfloat16)` does), products and sums are float32, the bias is added
// in float32 and the result rounded once.  The K index of a token is
// (py, px, c), the layout of vit.patchify.
//
// K4 bound on an H100: 2*B*seq*K*d operations (14.5 GFLOP at B=3, seq
// 1024, K 3072, d 768) against ~31 MB moved, so operations bound it (0.0147
// ms at 989 TFLOP/s bf16).  Design.  The Pallas kernel assembles a whole
// 1024^2x3 canvas (12 MiB) in VMEM over K serial DMA steps and then
// multiplies; a CUDA block has 227 KB and blocks run in no order, so K4 is
// an implicit GEMM instead: one block per (canvas, token row, 32-token
// segment of it, 128 columns of d).  The block first compacts the records
// that touch its 32 pixel rows and its column span into shared memory (as K1
// does), then walks the K dimension 32 at a time: the A tile is gathered
// straight from the slots through those records (zero where no placement
// covers a pixel; consecutive threads read consecutive canvas elements, so
// the reads are coalesced) and the B tile is read from the weights.  With
// bf16 weights (the main path) the 8 warps multiply the bf16 tiles on the
// tensor cores with WMMA 16x16x16 fragments and float32 accumulators; with
// float32 weights each thread accumulates a 4x4 output tile with float32
// FMAs (the tensor cores' TF32 would miss the float32 tolerance).  No
// canvas is written anywhere.  wgmma, TMA and a deeper pipeline are later
// work, so K4 sits well above its bound.
//
// K3 computes, per canvas cell, objectness sigmoid(r0), centre
// ((g + sigmoid(r1|r2)) * patch) and size exp(clip(r3|r4, -6, 6)) * patch;
// a cell whose centre lies in a placement is written to that placement's
// slot, its box clipped to the placement and made placement-local.  Bound:
// bytes (the raw head read once, the ~2.6 MB grid written once), under a
// microsecond, so launch overhead dominates.  Design: one block per (canvas,
// record) and cell tile; invalid records return at once.  The caller hands
// in a zeroed output, so cells no placement claims and slots no record
// references are 0 (the Pallas kernel leaves unreferenced slots undefined).
//
// Contract: every valid record lies inside its canvas, fits its slot and
// indexes a slot of the slot array (ops.check_records on the host).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;   // tokens per K4 block (a segment of one token row)
constexpr int kBN = 128;  // columns of d per K4 block
constexpr int kBK = 32;   // K-step
constexpr int kTM = 4;    // tokens per thread (FMA kernel)
constexpr int kTN = 4;    // columns per thread (FMA kernel)
constexpr int kALd = kBK + 8;   // bf16 tile strides (WMMA kernel): a
constexpr int kBLd = kBN + 8;   // multiple of 8 elements, rows 32-byte
constexpr int kCLd = kBN + 4;   // aligned; f32 stride a multiple of 4

struct Rec {
  int slot, x, y, w, h;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Keep the valid records of canvas b that meet canvas rows [row0, row0 +
// patch) and columns [col0, col1); returns their count.  Order does not
// matter: placements never overlap.
__device__ __forceinline__ int compact_records(const int* __restrict__ records,
                                               int b, int k, int row0,
                                               int patch, int col0, int col1,
                                               Rec* live, int* n_live) {
  if (threadIdx.x == 0) *n_live = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int* r = records + ((int64_t)b * k + i) * 6;
    if (r[0] > 0 && r[3] < row0 + patch && r[3] + r[5] > row0 &&
        r[2] < col1 && r[2] + r[4] > col0) {
      live[atomicAdd(n_live, 1)] = Rec{r[1], r[2], r[3], r[4], r[5]};
    }
  }
  __syncthreads();
  return *n_live;
}

// The stitched canvas pixel that K index kg of token column tx reads, in
// the token row whose pixels start at canvas row row0; 0 where no placement
// covers it.
__device__ __forceinline__ float gather_pixel(const float* __restrict__ slots,
                                              const Rec* live, int count,
                                              int hmax, int wmax, int c,
                                              int row0, int tx, int kg,
                                              int pc) {
  const int py = kg / pc;
  const int xe = tx * pc + (kg - py * pc);
  const int y = row0 + py;
  const int x = xe / c;
  for (int j = 0; j < count; ++j) {
    const Rec q = live[j];
    if (y >= q.y && y < q.y + q.h && x >= q.x && x < q.x + q.w) {
      return slots[(((int64_t)q.slot * hmax + (y - q.y)) * wmax +
                    (x - q.x)) * c + (xe - x * c)];
    }
  }
  return 0.0f;
}

__global__ void __launch_bounds__(kThreads)
stitch_embed_wmma_kernel(const float* __restrict__ slots,
                         const int* __restrict__ records,
                         const __nv_bfloat16* __restrict__ wk,
                         const __nv_bfloat16* __restrict__ bias,
                         __nv_bfloat16* __restrict__ out, int hmax, int wmax,
                         int c, int k, int patch, int side_n, int segments,
                         int kdim, int d) {
  namespace wmma = nvcuda::wmma;
  extern __shared__ Rec live[];  // at most k entries
  __shared__ int n_live;
  __shared__ __align__(32) __nv_bfloat16 a_tile[kBM][kALd];
  __shared__ __align__(32) __nv_bfloat16 b_tile[kBK][kBLd];
  __shared__ __align__(32) float c_tile[kBM][kCLd];

  const int b = blockIdx.z;
  const int ty = blockIdx.y / segments;
  const int tx0 = (blockIdx.y % segments) * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ntok = min(kBM, side_n - tx0);
  const int row0 = ty * patch;
  const int pc = patch * c;
  const int seq = (int)(gridDim.y / segments) * side_n;
  const int count = compact_records(records, b, k, row0, patch, tx0 * patch,
                                    (tx0 + ntok) * patch, live, &n_live);

  // warp w owns output rows [16 * (w % 2), +16) and the two 16-column
  // fragments starting at column 32 * (w / 2)
  const int warp = tid / 32;
  const int mi = warp % 2;
  const int nj = (warp / 2) * 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK;
      const int kk = e - mm * kBK;
      const int kg = k0 + kk;
      const float v = (mm < ntok && kg < kdim)
                          ? gather_pixel(slots, live, count, hmax, wmax, c,
                                         row0, tx0 + mm, kg, pc)
                          : 0.0f;
      a_tile[mm][kk] = __float2bfloat16_rn(v);
    }
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int nn = e - kk * kBN;
      const int kg = k0 + kk;
      const int ng = n0 + nn;
      b_tile[kk][nn] = (kg < kdim && ng < d) ? wk[(int64_t)kg * d + ng]
                                             : __float2bfloat16_rn(0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::load_matrix_sync(fa, &a_tile[mi * 16][ks], kALd);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fb;
        wmma::load_matrix_sync(fb, &b_tile[ks][(nj + j) * 16], kBLd);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    wmma::store_matrix_sync(&c_tile[mi * 16][(nj + j) * 16], acc[j], kCLd,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int mm = e / kBN;
    const int nn = e - mm * kBN;
    const int ng = n0 + nn;
    if (mm < ntok && ng < d) {
      out[((int64_t)b * seq + (int64_t)ty * side_n + tx0 + mm) * d + ng] =
          __float2bfloat16_rn(c_tile[mm][nn] + __bfloat162float(bias[ng]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stitch_embed_fma_kernel(const float* __restrict__ slots,
                        const int* __restrict__ records,
                        const float* __restrict__ wk,
                        const float* __restrict__ bias,
                        float* __restrict__ out, int hmax, int wmax, int c,
                        int k, int patch, int side_n, int segments, int kdim,
                        int d) {
  extern __shared__ Rec live[];  // at most k entries
  __shared__ int n_live;
  __shared__ float a_tile[kBM][kBK + 1];  // +1: conflict-free column writes
  __shared__ __align__(16) float b_tile[kBK][kBN];

  const int b = blockIdx.z;
  const int ty = blockIdx.y / segments;
  const int tx0 = (blockIdx.y % segments) * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int ntok = min(kBM, side_n - tx0);
  const int row0 = ty * patch;            // canvas rows [row0, row0 + patch)
  const int pc = patch * c;               // elements of one token pixel row
  const int seq = (int)(gridDim.y / segments) * side_n;
  const int count = compact_records(records, b, k, row0, patch, tx0 * patch,
                                    (tx0 + ntok) * patch, live, &n_live);

  const int tm = tid / 32;  // a warp shares its tokens: broadcast A reads
  const int tn = tid % 32;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < kdim; k0 += kBK) {
    // A: the canvas pixels of (token, k), gathered through the records
    for (int e = tid; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK;
      const int kk = e - mm * kBK;
      const int kg = k0 + kk;
      a_tile[mm][kk] = (mm < ntok && kg < kdim)
                           ? gather_pixel(slots, live, count, hmax, wmax, c,
                                          row0, tx0 + mm, kg, pc)
                           : 0.0f;
    }
    // B: the weights
    for (int e = tid; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN;
      const int nn = e - kk * kBN;
      const int kg = k0 + kk;
      const int ng = n0 + nn;
      b_tile[kk][nn] = (kg < kdim && ng < d) ? wk[(int64_t)kg * d + ng] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = a_tile[tm * kTM + i][kk];
      const float4 bv = *reinterpret_cast<const float4*>(&b_tile[kk][tn * kTN]);
      const float bb[kTN] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int mm = tm * kTM + i;
    if (mm >= ntok) continue;
    float* dst =
        out + ((int64_t)b * seq + (int64_t)ty * side_n + tx0 + mm) * d;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int ng = n0 + tn * kTN + j;
      if (ng < d) dst[ng] = acc[i][j] + bias[ng];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unstitch_decode_kernel(const T* __restrict__ raw,
                       const int* __restrict__ records,
                       float* __restrict__ out, int k, int side_m,
                       int side_n, int num_slots, float cell) {
  const int bk = blockIdx.x;  // b * k + record
  const int* r = records + (int64_t)bk * 6;
  const int slot = r[1];
  if (r[0] <= 0 || slot >= num_slots) return;
  const int b = bk / k;
  const float x0 = (float)r[2];
  const float y0 = (float)r[3];
  const float x1 = (float)(r[2] + r[4]);
  const float y1 = (float)(r[3] + r[5]);
  const int cells = side_m * side_n;
  for (int i = blockIdx.y * kThreads + threadIdx.x; i < cells;
       i += gridDim.y * kThreads) {
    const int gy = i / side_n;
    const int gx = i - gy * side_n;
    const T* v = raw + ((int64_t)b * cells + i) * 5;
    const float cx = ((float)gx + sigmoid(to_float(v[1]))) * cell;
    const float cy = ((float)gy + sigmoid(to_float(v[2]))) * cell;
    if (!(cx >= x0 && cx < x1 && cy >= y0 && cy < y1)) continue;
    const float bw = expf(fminf(fmaxf(to_float(v[3]), -6.0f), 6.0f)) * cell;
    const float bh = expf(fminf(fmaxf(to_float(v[4]), -6.0f), 6.0f)) * cell;
    float* o = out + ((int64_t)slot * cells + i) * 5;
    o[0] = sigmoid(to_float(v[0]));
    o[1] = fminf(fmaxf(cx - bw / 2.0f, x0), x1) - x0;
    o[2] = fminf(fmaxf(cy - bh / 2.0f, y0), y1) - y0;
    o[3] = fminf(fmaxf(cx + bw / 2.0f, x0), x1) - x0;
    o[4] = fminf(fmaxf(cy + bh / 2.0f, y0), y1) - y0;
  }
}

template <typename T, typename Kernel>
int launch_stitch_embed(Kernel kernel, const float* slots, const int* records,
                        const void* wk, const void* bias, void* out, int hmax,
                        int wmax, int c, int b, int k, int m, int n,
                        int patch, int d, cudaStream_t stream) {
  const int side_m = m / patch;
  const int side_n = n / patch;
  const int segments = (side_n + kBM - 1) / kBM;
  const size_t dyn = sizeof(Rec) * (size_t)k;
  // the record list can take the dynamic shared memory past 48 KB
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((d + kBN - 1) / kBN, side_m * segments, b);
  kernel<<<grid, kThreads, dyn, stream>>>(
      slots, records, static_cast<const T*>(wk), static_cast<const T*>(bias),
      static_cast<T*>(out), hmax, wmax, c, k, patch, side_n, segments,
      patch * patch * c, d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_unstitch_decode(const void* raw, const int* records, float* out,
                           int b, int k, int side_m, int side_n,
                           int num_slots, int patch, cudaStream_t stream) {
  const int cells = side_m * side_n;
  dim3 grid(b * k, (cells + kThreads - 1) / kThreads);
  unstitch_decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(raw), records, out, k, side_m, side_n, num_slots,
      (float)patch);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream`, never synchronise, allocate nothing
// and return a CUDA error code (0 on success).  `bf16` selects the weight
// (K4) or raw head (K3) type: 1 bfloat16, 0 float32.
extern "C" int tangram_stitch_embed(const void* slots, const int* records,
                                    const void* kernel, const void* bias,
                                    void* tokens, int hmax, int wmax, int c,
                                    int b, int k, int m, int n, int patch,
                                    int d, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* px = static_cast<const float*>(slots);
  if (bf16) {
    return launch_stitch_embed<__nv_bfloat16>(
        stitch_embed_wmma_kernel, px, records, kernel, bias, tokens, hmax,
        wmax, c, b, k, m, n, patch, d, s);
  }
  return launch_stitch_embed<float>(stitch_embed_fma_kernel, px, records,
                                    kernel, bias, tokens, hmax, wmax, c, b,
                                    k, m, n, patch, d, s);
}

extern "C" int tangram_unstitch_decode(const void* raw, const int* records,
                                       void* grids, int b, int k, int side_m,
                                       int side_n, int num_slots, int patch,
                                       int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(grids);
  if (bf16) {
    return launch_unstitch_decode<__nv_bfloat16>(
        raw, records, out, b, k, side_m, side_n, num_slots, patch, s);
  }
  return launch_unstitch_decode<float>(raw, records, out, b, k, side_m,
                                       side_n, num_slots, patch, s);
}
