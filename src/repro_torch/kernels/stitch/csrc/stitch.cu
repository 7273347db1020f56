// Batched canvas stitch (K1) and unstitch (K2) for Hopper (sm_90a).
//
// Replaces the TPU kernels in src/repro/kernels/stitch/stitch.py:
//   K1 stitch_pallas   (:73)  - patch slots -> zero-filled canvases
//   K2 unstitch_pallas (:132) - canvases -> zero-padded patch slots
//
// Layouts (all row-major, contiguous):
//   slots    (P, hmax, wmax, C)
//   records  (B, K, 6) int32 = (valid, slot, x, y, w, h)
//   canvases (B, M, N, C)
// Elements are copied as opaque 1-, 2- or 4-byte words, so the result is
// bit-exact for uint8/int8, bf16/fp16 and f32 payloads.
//
// Bound on an H100: both kernels only move data, so the least time is
// (bytes read + bytes written) / 3.35 TB/s.  K1 reads each valid placement's
// h*w*C elements once and writes the whole canvas batch once; K2 reads each
// placement's region once and the (P, hmax, wmax, C) output is written once.
//
// Design.  The Pallas K1 keeps a whole canvas resident in VMEM across K
// sequential grid steps; a 1024^2x3 canvas does not fit in a block's 227 KB
// of shared memory, and CUDA blocks run in no order.  Placements never
// overlap, so K1 is written as a gather instead: one block per (row tile,
// canvas) loads the canvas's records that touch its rows into shared memory,
// and every thread writes each of its output elements exactly once - the
// covering placement's slot element, or zero.  The zero fill costs no extra
// pass and the writes along a canvas row stay coalesced.  K2 is one block per
// (record, row tile of the slot): invalid records return at once, valid ones
// copy their (h, w) region into the output, which the caller hands in zeroed
// (slot padding and slots no record references stay 0).
//
// Contract: every valid record lies inside its canvas, fits its slot and
// indexes a slot of the slot array.  The kernels do not re-check it; the host
// rejects plans that break it before launch (ops.check_records).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // canvas rows per K1 block, slot rows per K2 block

struct Rec {
  int slot, x, y, w, h;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
stitch_kernel(const T* __restrict__ slots, const int* __restrict__ records,
              T* __restrict__ out, int hmax, int wmax, int c, int k, int m,
              int n) {
  extern __shared__ Rec live[];  // at most k entries
  __shared__ int n_live;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(r0 + kRows, m);
  if (threadIdx.x == 0) n_live = 0;
  __syncthreads();
  // keep the valid records whose rows meet [r0, r1); order is irrelevant
  // because placements never overlap
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const int* rec = records + ((int64_t)b * k + i) * 6;
    const int slot = rec[1], x = rec[2], y = rec[3], w = rec[4], h = rec[5];
    if (rec[0] > 0 && y < r1 && y + h > r0) {
      live[atomicAdd(&n_live, 1)] = Rec{slot, x, y, w, h};
    }
  }
  __syncthreads();
  const int count = n_live;
  const int row_elems = n * c;
  for (int r = r0; r < r1; ++r) {
    T* dst = out + ((int64_t)b * m + r) * row_elems;
    for (int e = threadIdx.x; e < row_elems; e += blockDim.x) {
      T v = T(0);
      for (int j = 0; j < count; ++j) {
        const Rec q = live[j];
        const int e0 = q.x * c;
        if (r >= q.y && r < q.y + q.h && e >= e0 && e < e0 + q.w * c) {
          v = slots[((int64_t)q.slot * hmax + (r - q.y)) * wmax * c +
                    (e - e0)];
          break;
        }
      }
      dst[e] = v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
unstitch_kernel(const T* __restrict__ canvases,
                const int* __restrict__ records, T* __restrict__ out,
                int hmax, int wmax, int c, int k, int m, int n) {
  const int bk = blockIdx.x;  // b * k + record
  const int* rec = records + (int64_t)bk * 6;
  const int slot = rec[1], x = rec[2], y = rec[3], w = rec[4], h = rec[5];
  const int r0 = blockIdx.y * kRows;
  if (rec[0] <= 0 || r0 >= h) return;
  const int b = bk / k;
  const int r1 = min(r0 + kRows, h);
  const int copy_elems = w * c;
  for (int r = r0; r < r1; ++r) {
    T* dst = out + ((int64_t)slot * hmax + r) * wmax * c;
    const T* src = canvases + (((int64_t)b * m + y + r) * n + x) * c;
    for (int e = threadIdx.x; e < copy_elems; e += blockDim.x) {
      dst[e] = src[e];
    }
  }
}

template <typename T>
void launch_stitch(const void* slots, const int* records, void* out,
                   int hmax, int wmax, int c, int b, int k,
                   int m, int n, cudaStream_t stream) {
  dim3 grid((m + kRows - 1) / kRows, b);
  stitch_kernel<T><<<grid, kThreads, sizeof(Rec) * k, stream>>>(
      static_cast<const T*>(slots), records, static_cast<T*>(out), hmax,
      wmax, c, k, m, n);
}

template <typename T>
void launch_unstitch(const void* canvases, const int* records, void* out,
                     int hmax, int wmax, int c, int b, int k,
                     int m, int n, cudaStream_t stream) {
  dim3 grid(b * k, (hmax + kRows - 1) / kRows);
  unstitch_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(canvases), records, static_cast<T*>(out), hmax,
      wmax, c, k, m, n);
}

}  // namespace

// Both entry points launch on `stream`, never synchronise, and return
// cudaGetLastError() (0 on success).  The caller allocates every buffer; for
// K2 it hands in a zeroed output, so slots no valid record references stay 0.
extern "C" int tangram_stitch(const void* slots, const int* records,
                              void* out, int hmax, int wmax,
                              int c, int b, int k, int m, int n,
                              int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      launch_stitch<uint8_t>(slots, records, out, hmax, wmax, c,
                             b, k, m, n, s);
      break;
    case 2:
      launch_stitch<uint16_t>(slots, records, out, hmax, wmax, c,
                              b, k, m, n, s);
      break;
    case 4:
      launch_stitch<uint32_t>(slots, records, out, hmax, wmax, c,
                              b, k, m, n, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tangram_unstitch(const void* canvases, const int* records,
                                void* out, int hmax, int wmax,
                                int c, int b, int k, int m, int n,
                                int elem_bytes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 1:
      launch_unstitch<uint8_t>(canvases, records, out, hmax, wmax,
                               c, b, k, m, n, s);
      break;
    case 2:
      launch_unstitch<uint16_t>(canvases, records, out, hmax, wmax,
                                c, b, k, m, n, s);
      break;
    case 4:
      launch_unstitch<uint32_t>(canvases, records, out, hmax, wmax,
                                c, b, k, m, n, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
