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
// h*w*C elements once and writes the whole canvas batch once (~60 MB at the
// main path's B=3 1024^2x3 f32 canvases); K2 reads each placement's region
// once and the (P, hmax, wmax, C) output is written once.
//
// K1 design.  The Pallas K1 keeps a whole canvas resident in VMEM across K
// sequential grid steps; a 1024^2x3 canvas does not fit in a block's 227 KB
// of shared memory, and CUDA blocks run in no order.  So K1 is a row-tile
// gather: one block per (tile of R canvas rows, canvas) writes every byte of
// its rows exactly once - the owning placement's slot bytes, or zero - so
// the zero fill costs no extra pass.  What bounds it is the write of the
// canvas batch and the read of the placed pixels, so the design keeps
// per-byte work to a load and a store, both coalesced:
//   1. the block keeps, in shared memory, the indices of its canvas's valid
//      records that meet its rows (the K records are read once), and for
//      each the offset of canvas pixel (0, 0) in its slot;
//   2. it builds an int16 owner map of its R rows x N columns, filled with
//      -1; each live record (a warp a record) writes its index k into the
//      columns it covers, as a max over 32-bit words (compare-and-swap), so
//      the highest k owns a pixel whatever order the list was built in:
//      overlapping placements give the reference's answer (the last record
//      in k order wins);
//   3. each warp walks its rows in spans of 32 x 16 canvas elements: lane l
//      loads elements l, l + 32, ... (one owner lookup and one offset a
//      element, no branch on the owner's record, so the 16 loads of a lane
//      are in flight together; neighbouring lanes read neighbouring slot
//      elements) into the warp's span buffer, then writes the span with
//      S-byte stores, lane l taking chunks l, l + 32, ... so that a store
//      instruction covers 32 x S contiguous bytes.
// The wrapper's stitch.stitch_plan picks R and the store width S: 16 bytes,
// or narrower when a canvas row is not a multiple of 16 bytes (same kernel,
// no fallback), so that groups of whole pixels tile every row and every
// store is aligned.  Offsets are 32-bit (the wrapper checks that the slot
// array and a canvas row fit int32); only the canvas base is 64-bit.
//
// Two earlier versions ran no faster than the per-element record scan this
// replaced (PERF.md): one gave each thread a group of whole pixels,
// so lanes were 48 bytes apart in every instruction and a thread had one
// group's loads in flight at a time; the other stored each value to the
// span buffer as it arrived, which ordered every load after the store
// before it.  Hence step 3 loads into registers first.
//
// K2 is one block per (record, row tile of the slot): invalid records
// return at once, valid ones copy their (h, w) region into the output,
// which the caller hands in zeroed (slot padding and slots no record
// references stay 0).
//
// Contract: every valid record lies inside its canvas, fits its slot and
// indexes a slot of the slot array.  The kernels do not re-check it; the host
// rejects plans that break it before launch (ops.check_records).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // slot rows per K2 block
// stitch.MAX_RECORDS_PER_CANVAS: a record index fits int16, and the live
// list of one block holds at most this many
constexpr int kMaxRecords = 2048;
constexpr int kLaneElems = 16;  // canvas elements a K1 lane loads a span

// S bytes as one register type: one load or store instruction.
template <int S> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<1> { using type = uint8_t; };

// Set the owner of column 2*word (lo) and/or 2*word+1 (hi) to k where k is
// higher than the owner there: a max over the int16 halves of one word.
__device__ __forceinline__ void claim(uint32_t* word, bool lo, bool hi,
                                      int k) {
  uint32_t old = *word;
  while (true) {
    const int cur_lo = (int16_t)(old & 0xffffu);
    const int cur_hi = (int16_t)(old >> 16);
    const uint32_t new_lo = (lo && k > cur_lo) ? (uint32_t)k : old & 0xffffu;
    const uint32_t new_hi = (hi && k > cur_hi) ? (uint32_t)k : old >> 16;
    const uint32_t val = new_lo | (new_hi << 16);
    if (val == old) return;
    const uint32_t seen = atomicCAS(word, old, val);
    if (seen == old) return;
    old = seen;
  }
}

// K1: one block per (tile of `rows` canvas rows, canvas).  Dynamic shared
// memory, in this order: the owner map (rows x pitch int16, pitch = N
// rounded up to 8), the live list (kMaxRecords int16) and its count (16 B),
// each record's slot base (kMaxRecords uint32), and one span buffer a warp
// (32 * kLaneElems elements).
template <typename T, int S>
__global__ void __launch_bounds__(kThreads)
stitch_kernel(const T* __restrict__ slots, const int* __restrict__ records,
              T* __restrict__ out, int hmax, int wmax, int c, int k, int m,
              int n, int rows) {
  using Word = typename Raw<S>::type;  // one store
  constexpr int V = S / sizeof(T);       // elements a store
  constexpr int kSpan = 32 * kLaneElems;  // elements a warp assembles
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = (n + 7) & ~7;
  int16_t* owner = reinterpret_cast<int16_t*>(smem);
  int16_t* live = owner + rows * pitch;
  int* n_live = reinterpret_cast<int*>(live + kMaxRecords);
  uint32_t* base = reinterpret_cast<uint32_t*>(live + kMaxRecords + 8);
  T* span_buf = reinterpret_cast<T*>(base + kMaxRecords) +
                (threadIdx.x >> 5) * kSpan;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, m);
  const int* recs = records + (int64_t)b * k * 6;
  const uint32_t row_elems = (uint32_t)wmax * c;  // elements of a slot row

  // the owner map starts at -1 everywhere (16-byte stores of all ones)
  uint4* words = reinterpret_cast<uint4*>(owner);
  for (int i = threadIdx.x; i < rows * pitch / 8; i += kThreads) {
    words[i] = make_uint4(~0u, ~0u, ~0u, ~0u);
  }
  if (threadIdx.x == 0) *n_live = 0;
  __syncthreads();
  // 1. the valid records that meet rows [r0, r1), in any order, and where
  //    pixel (0, 0) of the canvas would sit in each one's slot: canvas
  //    element e of row r is slots[base + r * row_elems + e] (mod 2^32)
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const int* rec = recs + i * 6;
    const int x = rec[2], y = rec[3];
    if (rec[0] > 0 && y < r1 && y + rec[5] > r0) {
      live[atomicAdd(n_live, 1)] = (int16_t)i;
      base[i] = (uint32_t)rec[1] * (uint32_t)hmax * row_elems -
                (uint32_t)y * row_elems - (uint32_t)x * c;
    }
  }
  __syncthreads();
  // 2. each live record claims its columns on its rows, a warp a record;
  //    the highest k wins whatever the order of the list
  const int count = *n_live;
  uint32_t* map32 = reinterpret_cast<uint32_t*>(owner);
  for (int j = threadIdx.x >> 5; j < count; j += kThreads / 32) {
    const int kk = live[j];
    const int* rec = recs + kk * 6;
    const int x = rec[2], y = rec[3], w = rec[4], h = rec[5];
    const int ry0 = max(y, r0) - r0;
    const int ry1 = min(y + h, r1) - r0;
    const int w0 = x >> 1;
    const int nw = ((x + w - 1) >> 1) - w0 + 1;
    for (int rr = ry0; rr < ry1; ++rr) {
      uint32_t* row = map32 + (rr * pitch >> 1);
      for (int wi = w0 + lane; wi < w0 + nw; wi += 32) {
        claim(row + wi, 2 * wi >= x, 2 * wi + 1 < x + w, kk);
      }
    }
  }
  __syncthreads();
  // 3. each warp assembles spans of kSpan canvas elements in its buffer -
  //    lane l loads elements l, l + 32, ... (coalesced along the placement
  //    row, zero where no record owns the pixel) - and writes each span
  //    with S-byte stores, chunk l, l + 32, ... (contiguous across lanes)
  const int canvas_row = n * c;
  const int spans = (canvas_row + kSpan - 1) / kSpan;
  const int step_px = 32 / c, step_ch = 32 % c;
  for (int s = threadIdx.x >> 5; s < (r1 - r0) * spans; s += kThreads / 32) {
    const int r = r0 + s / spans;
    const int e0 = (s % spans) * kSpan;
    const int16_t* own = owner + (r - r0) * pitch;
    const uint32_t row_off = (uint32_t)r * row_elems;
    int e = e0 + lane;
    int px = e / c;
    int ch = e - px * c;
    // all loads first, into registers: a store to the span buffer between
    // them would order each load after the one before
    T v[kLaneElems];
#pragma unroll
    for (int j = 0; j < kLaneElems; ++j) {
      const int o = own[min(px, n - 1)];
      const bool hit = e < canvas_row && o >= 0;
      v[j] = hit ? slots[base[hit ? o : 0] + row_off + (uint32_t)e] : T(0);
      e += 32;
      px += step_px;
      ch += step_ch;
      if (ch >= c) {
        ch -= c;
        ++px;
      }
    }
#pragma unroll
    for (int j = 0; j < kLaneElems; ++j) span_buf[lane + 32 * j] = v[j];
    __syncwarp();
    T* dst = out + ((int64_t)b * m + r) * canvas_row + e0;
#pragma unroll
    for (int j = 0; j < kLaneElems / V; ++j) {
      const int chunk = lane + 32 * j;
      if (e0 + chunk * V < canvas_row) {
        *reinterpret_cast<Word*>(dst + chunk * V) =
            *reinterpret_cast<const Word*>(span_buf + chunk * V);
      }
    }
    __syncwarp();
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

template <typename T, int S>
int launch_stitch(const void* slots, const int* records, void* out, int hmax,
                  int wmax, int c, int b, int k, int m, int n, int rows,
                  int group, int smem, cudaStream_t stream) {
  auto kernel = stitch_kernel<T, S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + rows - 1) / rows, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(slots), records, static_cast<T*>(out), hmax,
      wmax, c, k, m, n, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_stitch(const void* slots, const int* records, void* out,
                    int hmax, int wmax, int c, int b, int k, int m, int n,
                    int rows, int group, int store, int smem,
                    cudaStream_t s) {
  switch (store) {
    case 16:
      return launch_stitch<T, 16>(slots, records, out, hmax, wmax, c, b, k,
                                  m, n, rows, group, smem, s);
    case 8:
      return launch_stitch<T, 8>(slots, records, out, hmax, wmax, c, b, k,
                                 m, n, rows, group, smem, s);
    case 4:
      if constexpr (sizeof(T) <= 4) {
        return launch_stitch<T, 4>(slots, records, out, hmax, wmax, c, b, k,
                                   m, n, rows, group, smem, s);
      }
      break;
    case 2:
      if constexpr (sizeof(T) <= 2) {
        return launch_stitch<T, 2>(slots, records, out, hmax, wmax, c, b, k,
                                   m, n, rows, group, smem, s);
      }
      break;
    case 1:
      if constexpr (sizeof(T) == 1) {
        return launch_stitch<T, 1>(slots, records, out, hmax, wmax, c, b, k,
                                   m, n, rows, group, smem, s);
      }
      break;
  }
  return (int)cudaErrorInvalidValue;
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
// cudaGetLastError() (0 on success).  The caller allocates every buffer.
// K1 writes every byte of `out`, and launches from the wrapper's plan
// (stitch.stitch_plan): `rows` canvas rows a block, `store` bytes a store,
// `group` the pixels whose bytes are a multiple of the store, `smem` bytes
// of dynamic shared memory; a plan whose stores do not tile the canvas
// rows, or whose shared memory is short, is refused.  For K2 the caller
// hands in a zeroed output, so slots no valid record references stay 0.
extern "C" int tangram_stitch(const void* slots, const int* records,
                              void* out, int hmax, int wmax,
                              int c, int b, int k, int m, int n,
                              int elem_bytes, int rows, int group, int store,
                              int smem, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pitch = (n + 7) & ~7;
  if (rows < 1 || group < 1 || store < 1 || n % group != 0 ||
      (group * c * elem_bytes) % store != 0 || k > kMaxRecords ||
      smem < rows * pitch * 2 + kMaxRecords * 6 + 16 +
                 kThreads / 32 * 32 * kLaneElems * elem_bytes) {
    return (int)cudaErrorInvalidValue;
  }
  switch (elem_bytes) {
    case 1:
      return dispatch_stitch<uint8_t>(slots, records, out, hmax, wmax, c, b,
                                      k, m, n, rows, group, store, smem, s);
    case 2:
      return dispatch_stitch<uint16_t>(slots, records, out, hmax, wmax, c,
                                       b, k, m, n, rows, group, store, smem,
                                       s);
    case 4:
      return dispatch_stitch<uint32_t>(slots, records, out, hmax, wmax, c,
                                       b, k, m, n, rows, group, store, smem,
                                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
