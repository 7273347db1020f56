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
// an implicit GEMM instead, and no canvas is written anywhere.  bf16
// weights (the main path): one block per (192 columns of d, 128 tokens of
// one canvas, canvas), 96 blocks at B = 3 and 128 at B = 4, one wave on
// the 132 SMs.  The column tile is a template parameter: 192 is the
// default, 128 and 64 the narrower tiles launch/hillclimb.py times (at d
// 384 or 512 the default leaves 48 blocks on 132 SMs); every tile gives
// the same bits.  Before the K loop the block resolves its records once into
// a segment table: for each of its tokens and each of the token's `patch`
// canvas row segments, up to two runs (a left and a right slot segment,
// since a canvas row segment inside a placement is one contiguous slot
// segment) with the zeros between them; a segment cut into three or more
// runs (a placement narrower than a token) is flagged.  Warp roles (384
// threads): warpgroups 0 and 1 are consumers of 64 tokens x 192 columns
// each, whose float32 accumulators stay in registers through the whole
// 3072-deep K loop (wgmma m64n192k16, A and B from shared memory, 64-deep
// K steps); warpgroup 2 is the producer, one thread of which streams the
// weight tiles (64 x 192 bf16, three 64-column boxes, 128-byte swizzle; the
// weights stay in L2) with TMA into a ring of 3 stages completing on
// mbarriers; setmaxnreg
// moves registers from it (24) to the consumers (240).  Each consumer
// gathers its own 64 A rows of a step (64 K values, two a lane: one 16-byte
// table lookup a row, two coalesced f32 loads, one bf16 pair store, round
// to nearest even, into the 128-byte swizzled layout wgmma reads; a flagged
// segment scans the block's live records per pixel, out of line) into its
// rows of the A tile, with a proxy fence and a warpgroup barrier.  The loads
// of step s + 1 are issued right after the wgmma of step s, so they fly
// while the tensor cores work.  K steps start at a different offset in each
// block (the sum is the same), so the blocks of a column tile do not all
// ask L2 for one weight tile at once.  The epilogue adds the bias in
// float32 and rounds once, from registers.  Shared memory: 16 KB of A, 24
// KB a weight stage, 64 KB of table at patch 32, 20 B a record.  What
// holds it back: each step's gather, whose table lookups and f32 loads
// share the SM's shared-memory/L1 bandwidth with the wgmma operand reads
// and wait behind them, takes longer than the step's tensor work; moving
// the gather to producer warpgroups, deeper rings and wider lookups did
// not shorten it.  Later work:
// read the slots through fewer, wider loads (16-byte where rows align),
// share each gathered A tile across the column tiles of a cluster through
// distributed shared memory (the A bytes come through L2 four times now),
// and multicast the weight tiles.  float32 weights take an FMA kernel on
// the CUDA cores (TF32 would miss the float32 tolerance): one block per
// (canvas, token row, 32-token segment, 128 columns), A gathered through
// the block's records, 4x4 float32 outputs a thread, off the main path.
//
// K3 computes, per canvas cell, objectness sigmoid(r0), centre
// ((g + sigmoid(r1|r2)) * patch) and size exp(clip(r3|r4, -6, 6)) * patch;
// a cell whose centre lies in a placement is written to that placement's
// slot, its box clipped to the placement and made placement-local.  Bound:
// bytes (the raw head read once, the ~2.6 MB grid written once), under a
// microsecond, below the cost of one launch: what a design can do is make
// the call one launch that writes each output byte once, with the chain of
// dependent memory trips short and enough warps to hide the math.
// Design: slot-major, one block per (output slot, tile of 256 cells), so
// the output needs no zero fill beforehand (the wrapper allocates it with
// torch.empty) and no block exits without work.  The block finds its
// slot's owner with a warp max over the B*K records, read once with their
// placements (the winner's placement comes through shared memory, not a
// second read of the records): the last valid record, in (b, k) order,
// that names the slot, which is what the reference's loop and the Pallas
// grid order leave in a slot that two records name.  Each thread then
// decodes one cell of the owner's canvas (the raw head, 20-40 KB a canvas,
// stays in L2): decoded where the centre lies in the placement, zeros
// elsewhere and in a slot no valid record names (the Pallas kernel leaves
// such a slot undefined).  A warp writes its 32 cells' 640 bytes as 40
// contiguous 16-byte stores through a staging buffer (scalar stores when
// side_m * side_n is not a multiple of 4).  The hit test and decode are the
// same float ops, in the same order, as the plain version's.  A first
// version decoded 4 cells a thread (a 1024-cell tile a block, 128 blocks at
// the main path): with 8 warps an SM the transcendental math was exposed,
// and it ran slower than the memset and gather it replaced (PERF.md).
//
// Contract: every valid record lies inside its canvas, fits its slot and
// indexes a slot of the slot array (ops.check_records on the host).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 32;   // tokens per f32 K4 block (a segment of a token row)
constexpr int kBN = 128;  // columns of d per f32 K4 block
constexpr int kBK = 32;   // K-step
constexpr int kTM = 4;    // tokens per thread (FMA kernel)
constexpr int kTN = 4;    // columns per thread (FMA kernel)

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

// ------------------------------------------------------- K4, bf16 wgmma ----

constexpr int kWgThreads = 384;  // 2 consumer warpgroups + 1 producer
constexpr int kWgBM = 128;       // tokens a block (64 a consumer), one canvas
constexpr int kWgBK = 64;        // K step: one 128-byte swizzled row
constexpr int kWgStages = 3;     // weight ring depth
constexpr int kARows = 16;       // A rows a consumer thread gathers a step
constexpr int kAHalf = 64 * kWgBK * 2;          // a consumer's A tile
constexpr int kBBox = kWgBK * 64 * 2;           // one 64-column weight box
constexpr int kMultiRun = -1;  // split_hi of a segment cut into 3+ runs

// The block's columns of d (the tile's BN, the wgmma's N) are a template
// parameter: 192 (the default tile), 128 or 64, the column tiles the
// wrapper's K4_TILES names.  A tile of BN columns is BN / 64 weight boxes.
__host__ __device__ constexpr int b_bytes(int bn) { return (bn / 64) * kBBox; }

// Shared memory of one bf16 K4 block of `bn` columns (offsets from a
// 1024-byte aligned base): the A tile (kWgBM x kWgBK bf16), the weight
// ring, the segment table (kWgBM * patch int4), the block's live records,
// the barriers and the live count.
struct WgLayout {
  int a_off, b_off, seg_off, live_off, bar_off, bytes;
  __host__ __device__ WgLayout(int patch, int k, int bn) {
    a_off = 0;
    b_off = a_off + 2 * kAHalf;
    seg_off = b_off + kWgStages * b_bytes(bn);
    live_off = seg_off + kWgBM * patch * 16;
    bar_off = (live_off + k * (int)sizeof(Rec) + 7) / 8 * 8;
    // full and empty per stage; the live count; alignment slack
    bytes = bar_off + 2 * kWgStages * 8 + 8 + 1024;
  }
};

// Elements (xoff, xoff + 1) of canvas row segment py of token t when three
// or more runs cut it: each from the live record that covers its pixel, 0
// where none does.  Kept out of line: the gather calls it rarely.
__device__ __noinline__ float2 multi_run_pair(const float* __restrict__ slots,
                                              const Rec* live, int count,
                                              int hmax, int wmax, int c,
                                              int patch, int side_n, int t,
                                              int py, int xoff) {
  const int y = (t / side_n) * patch + py;
  const int xe = (t % side_n) * patch * c + xoff;
  float v[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int x = (xe + h) / c;
    for (int j = 0; j < count; ++j) {
      const Rec q = live[j];
      if (y >= q.y && y < q.y + q.h && x >= q.x && x < q.x + q.w) {
        v[h] = slots[(((int64_t)q.slot * hmax + (y - q.y)) * wmax +
                      (x - q.x)) * c + (xe + h - x * c)];
        break;
      }
    }
  }
  return make_float2(v[0], v[1]);
}

// Issue the loads of one consumer thread's share of an A step: rows
// row0 + 4 i of the block's tile, elements (xoff, xoff + 1) of canvas row
// segment py; one table lookup a row.  Returns the rows whose segment
// three or more runs cut (their values are filled in later).
__device__ __forceinline__ uint32_t gather_issue(
    float (&v)[kARows][2], const int4* seg4, const float* __restrict__ slots,
    int row0, int patch, int pc, int py, int xoff) {
  uint32_t multi = 0;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int4 e = seg4[(row0 + 4 * i) * patch + py];
    if (e.z > xoff + 1) {
      // the common case: both elements in the left run (a whole segment)
      const float* src = slots + e.x + xoff;
      v[i][0] = __ldg(src);
      v[i][1] = __ldg(src + 1);
    } else if (e.z == 0 && e.w >= pc) {
      v[i][0] = v[i][1] = 0.0f;   // no placement touches the segment
    } else {
      const bool many = e.w < 0;
      multi |= (uint32_t)many << i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int x = xoff + h;
        const int addr =
            many ? -1 : x < e.z ? e.x + x : x >= e.w ? e.y + x : -1;
        v[i][h] = addr >= 0 ? __ldg(slots + addr) : 0.0f;
      }
    }
  }
  return multi;
}

// Store one consumer thread's gathered share of an A step (rows row0 +
// 4 i of its warpgroup's 64-row tile, K pair 2 lane) as bf16 pairs (round to
// nearest even), 128-byte swizzled: 16-byte chunk j of row r at chunk
// j ^ (r % 8).  Rows that three or more runs cut are gathered here, per
// pixel, in a loop that is not unrolled (the code stays small).
__device__ __forceinline__ void gather_store(
    const float (&v)[kARows][2], uint32_t multi, unsigned char* tile,
    int row0, int lane, int tok_row0, const float* __restrict__ slots,
    const Rec* live, int count, int hmax, int wmax, int c, int patch,
    int side_n, int py, int xoff) {
  const int chunk = (2 * lane) / 8;
  const int col = ((2 * lane) % 8) * 2;
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const int r = row0 + 4 * i;
    *reinterpret_cast<__nv_bfloat162*>(
        tile + r * 128 + ((chunk ^ (r % 8)) * 16) + col) =
        __floats2bfloat162_rn(v[i][0], v[i][1]);
  }
  while (multi) {
    const int r = row0 + 4 * (__ffs(multi) - 1);
    multi &= multi - 1;
    const float2 pair = multi_run_pair(slots, live, count, hmax, wmax, c,
                                       patch, side_n, tok_row0 + r, py, xoff);
    *reinterpret_cast<__nv_bfloat162*>(
        tile + r * 128 + ((chunk ^ (r % 8)) * 16) + col) =
        __floats2bfloat162_rn(pair.x, pair.y);
  }
}

// D (64 x BN) += A (64 x 16) * B (16 x BN), B MN-major.
template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 192) {
    hopper::wgmma_ss_n192<1>(acc, da, db, 1);
  } else if constexpr (BN == 128) {
    hopper::wgmma_ss_n128<1>(acc, da, db, 1);
  } else {
    static_assert(BN == 64, "K4 column tiles are 192, 128 or 64");
    hopper::wgmma_ss_n64<1>(acc, da, db, 1);
  }
}

// One block per (BN columns of d, 128 tokens of one canvas, canvas).
// Token t of the canvas is (ty, tx) = (t / side_n, t % side_n); its K index
// kk = py * pc + xoff (pc = patch * c) reads canvas row ty * patch + py at
// element tx * pc + xoff of that row.  The column tile changes which
// columns a block owns, not the order in which any output sums over K (the
// K rotation below depends on the token tiles alone), so every tile gives
// the same bits.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
stitch_embed_wgmma_kernel(const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ slots,
                          const int* __restrict__ records,
                          const __nv_bfloat16* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int hmax, int wmax,
                          int c, int k, int patch, int side_m, int side_n,
                          int kdim, int d) {
  extern __shared__ unsigned char k4_raw[];
  unsigned char* smem = hopper::align_1024(k4_raw);
  constexpr int kBBytes = b_bytes(BN);
  const WgLayout lay(patch, k, BN);
  unsigned char* a_buf = smem + lay.a_off;
  unsigned char* b_ring = smem + lay.b_off;
  int4* seg4 = reinterpret_cast<int4*>(smem + lay.seg_off);
  Rec* live = reinterpret_cast<Rec*>(smem + lay.live_off);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + kWgStages;
  int* n_live = reinterpret_cast<int*>(empty + kWgStages);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int tok0 = blockIdx.y * kWgBM;
  const int b = blockIdx.z;
  const int seq = side_m * side_n;
  const int ntok = min(kWgBM, seq - tok0);
  const int pc = patch * c;
  const int ty0 = tok0 / side_n;
  const int ty1 = (tok0 + ntok - 1) / side_n;   // inclusive
  const int n_steps = kdim / kWgBK;

  // ---- resolve the records once: the segment table ----
  // seg4[m * patch + py] = (left, right, split_lo, split_hi) for token m's
  // canvas row segment py: element x (0 <= x < pc) of it is
  // slots[left + x] if x < split_lo, slots[right + x] if x >= split_hi,
  // else 0 (within a placement a canvas row segment is one contiguous slot
  // segment).  A placement covering the whole segment sets split_lo = pc;
  // one covering its left end sets left and split_lo, one covering its right
  // end right and split_hi; one strictly inside it (a third run) sets
  // split_hi = kMultiRun.  Placements never overlap, so no field has two
  // writers but split_hi, which takes the minimum.
  if (tid == 0) {
    *n_live = 0;
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);   // lane 0 of each consumer warp
    }
    hopper::fence_barrier_init();
  }
  for (int e = tid; e < kWgBM * patch; e += kWgThreads) {
    seg4[e] = make_int4(0, 0, 0, pc);
  }
  __syncthreads();
  for (int i = tid; i < k; i += kWgThreads) {
    const int* r = records + ((int64_t)b * k + i) * 6;
    if (r[0] > 0 && r[3] < (ty1 + 1) * patch && r[3] + r[5] > ty0 * patch) {
      live[atomicAdd(n_live, 1)] = Rec{r[1], r[2], r[3], r[4], r[5]};
    }
  }
  __syncthreads();
  const int count = *n_live;
  {
    const int warp = tid / 32;
    const int lane = tid % 32;
    for (int i = warp; i < count; i += kWgThreads / 32) {
      const Rec q = live[i];
      const int ya = max(q.y, ty0 * patch);
      const int yb = min(q.y + q.h, (ty1 + 1) * patch);   // exclusive
      const int xa = q.x / patch;
      const int nx = (q.x + q.w - 1) / patch - xa + 1;
      for (int j = lane; j < (yb - ya) * nx; j += 32) {
        const int y = ya + j / nx;
        const int tx = xa + j % nx;
        const int m = (y / patch) * side_n + tx - tok0;
        if (m < 0 || m >= ntok) continue;
        const int sx = tx * patch;
        const int base = ((q.slot * hmax + (y - q.y)) * wmax + (sx - q.x)) * c;
        const bool left = q.x <= sx;
        const bool right = q.x + q.w >= sx + patch;
        int4* e = &seg4[m * patch + y % patch];
        if (left && right) {
          *e = make_int4(base, 0, pc, pc);
        } else if (left) {
          e->x = base;
          e->z = (q.x + q.w - sx) * c;
        } else if (right) {
          e->y = base;
          atomicMin(&e->w, (q.x - sx) * c);
        } else {
          atomicMin(&e->w, kMultiRun);
        }
      }
    }
  }
  __syncthreads();

  // Blocks walk K from different steps (the sum is the same; float32 adds
  // in another order), so the blocks of one column tile do not all ask L2
  // for the same weight tile at once.
  const int rot = ((blockIdx.z * gridDim.y + blockIdx.y) * 7) % n_steps;
  if (tid >= 256) {
    // ---- producer warpgroup: one thread streams the weight tiles ----
    hopper::reg_dealloc<24>();
    if (tid == 256) {
      for (int s = 0; s < n_steps; ++s) {
        const int st = s % kWgStages;
        const int ks = (s + rot) % n_steps;
        hopper::mbar_wait(&empty[st], ((s / kWgStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[st], kBBytes);
        for (int j = 0; j < BN / 64; ++j) {
          hopper::tma_load_2d(b_ring + st * kBBytes + j * kBBox, &wmap,
                              &full[st], n0 + 64 * j, ks * kWgBK);
        }
      }
    }
  } else {
    // ---- consumers: each gathers its own 64 A rows a step and keeps 64
    // tokens x BN columns in registers.
    hopper::reg_alloc<240>();
    const int wg = tid / 128;
    const int wq = (tid % 128) / 32;
    const int lane = tid % 32;
    const int bar_id = 1 + wg;           // named barrier of this warpgroup
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
    // this warpgroup's rows of the A tile: the wgmma that read them last
    // has finished (waited at the end of each step) before they are stored
    unsigned char* a_tile = a_buf + wg * kAHalf;

    // Step s runs K step (s + rot) % n_steps; its A values are loaded into
    // v during step s - 1's products.
    float v[kARows][2];
    int kk = rot * kWgBK + 2 * lane;
    int py = kk / pc;
    uint32_t multi = gather_issue(v, seg4, slots, wg * 64 + wq, patch, pc,
                                  py, kk - py * pc);
    for (int s = 0; s < n_steps; ++s) {
      gather_store(v, multi, a_tile, wq, lane, tok0 + wg * 64, slots, live,
                   count, hmax, wmax, c, patch, side_n, py, kk - py * pc);
      hopper::fence_proxy_async();
      asm volatile("bar.sync %0, 128;\n" ::"r"(bar_id) : "memory");
      const int st = s % kWgStages;
      hopper::mbar_wait(&full[st], (s / kWgStages) & 1);
      const unsigned char* b_st = b_ring + st * kBBytes;
      // (no register fence on acc around the batches: an instruction that
      // defines acc inside the wgmma pipeline makes ptxas serialize it)
      hopper::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kWgBK / 16; ++k16) {
        // A K-major (32 bytes a k-step); B MN-major (16 rows a k-step,
        // 64-column blocks kBBox apart)
        const uint64_t da =
            hopper::smem_desc(a_tile + k16 * 32, 16, 1024, 128);
        const uint64_t db =
            hopper::smem_desc(b_st + k16 * 16 * 128, kBBox, 1024, 128);
        wgmma_tile<BN>(acc, da, db);
      }
      hopper::wgmma_commit();
      // the next step's loads fly while the tensor cores work
      if (s + 1 < n_steps) {
        kk = ((s + 1 + rot) % n_steps) * kWgBK + 2 * lane;
        py = kk / pc;
        multi = gather_issue(v, seg4, slots, wg * 64 + wq, patch, pc, py,
                             kk - py * pc);
      }
      // the products are done: the weight stage is free (the other
      // warpgroup's products run while this one stores its next A)
      hopper::wgmma_wait<0>();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    // epilogue from registers: bias in float32, one rounding
    const int m_a = wg * 64 + wq * 16 + lane / 4;
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int m = (i & 2) ? m_a + 8 : m_a;
      const int col = n0 + 8 * (i / 4) + 2 * (lane % 4);
      if (m >= ntok || col >= d) continue;
      const float b0 = __bfloat162float(bias[col]);
      const float b1 = __bfloat162float(bias[col + 1]);
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((int64_t)b * seq + tok0 + m) * d + col) =
          __floats2bfloat162_rn(acc[i] + b0, acc[i + 1] + b1);
    }
  }
}

template <int BN>
int launch_stitch_embed_wgmma(const float* slots, const int* records,
                              const void* wk, const void* bias, void* out,
                              int hmax, int wmax, int c, int b, int k, int m,
                              int n, int patch, int d, cudaStream_t stream) {
  const int side_m = m / patch;
  const int side_n = n / patch;
  const int kdim = patch * patch * c;
  // the weights (kdim, d): boxes of 64 rows of K x 64 columns of d
  CUtensorMap wmap;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)kdim};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)kWgBK};
  int rc = hopper::encode_bf16_map(&wmap, wk, 2, dims, strides, box, 128);
  if (rc != 0) return rc;
  const WgLayout lay(patch, k, BN);
  cudaError_t err = cudaFuncSetAttribute(
      stitch_embed_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, lay.bytes);
  if (err != cudaSuccess) return (int)err;
  const int seq = side_m * side_n;
  dim3 grid((d + BN - 1) / BN, (seq + kWgBM - 1) / kWgBM, b);
  stitch_embed_wgmma_kernel<BN><<<grid, kWgThreads, lay.bytes, stream>>>(
      wmap, slots, records, static_cast<const __nv_bfloat16*>(bias),
      static_cast<__nv_bfloat16*>(out), hmax, wmax, c, k, patch, side_m,
      side_n, kdim, d);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K3 ----

constexpr int kDecTile = kThreads;  // cells a K3 block writes, one a thread

// K3, slot-major: one block per (output slot, tile of kDecTile cells).  The
// block finds the slot's owner - the last valid record, in (b, k) order,
// that names the slot, as the reference's loop and Pallas's grid order
// leave it - and writes every cell of its tile exactly once: decoded where
// the cell's centre lies in the owner's placement, else zeros (all zeros
// when no record names the slot).  A thread decodes one cell.  kVec:
// side_m * side_n is a multiple of 4, so a warp's 32 cells (640 bytes)
// start 16-byte aligned and leave through the warp's staging buffer as 40
// contiguous 16-byte stores; otherwise each thread stores its 5 floats.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
unstitch_decode_kernel(const T* __restrict__ raw,
                       const int* __restrict__ records,
                       float* __restrict__ out, int n_records, int k,
                       int side_m, int side_n, float cell) {
  // each warp's candidate: its highest index and that record's placement
  __shared__ int4 warp_place[kThreads / 32];
  __shared__ int warp_owner[kThreads / 32];
  __shared__ __align__(16) float stage[kThreads * 5];
  const int slot = blockIdx.x;
  int owner = -1;  // the highest b * k + record naming the slot
  int4 place = make_int4(0, 0, 0, 0);  // its (x, y, w, h)
  for (int i = threadIdx.x; i < n_records; i += kThreads) {
    // the whole record at once (three 8-byte loads), so the placement
    // needs no second trip to memory once the slot matches
    const int2* r = reinterpret_cast<const int2*>(records) + (int64_t)i * 3;
    const int2 vs = r[0], xy = r[1], wh = r[2];
    if (vs.x > 0 && vs.y == slot) {
      owner = i;
      place = make_int4(xy.x, xy.y, wh.x, wh.y);
    }
  }
  const int warp_max = __reduce_max_sync(0xffffffffu, owner);
  if (owner == warp_max) {  // the lane that holds it (or all, at -1)
    warp_owner[threadIdx.x >> 5] = owner;
    warp_place[threadIdx.x >> 5] = place;
  }
  __syncthreads();
  int from = 0;
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) {
    if (warp_owner[i] > warp_owner[from]) from = i;
  }
  owner = warp_owner[from];

  const int cells = side_m * side_n;
  const int i = blockIdx.y * kDecTile + threadIdx.x;  // this thread's cell
  float o[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (owner >= 0 && i < cells) {
    const int b = owner / k;
    const int4 p = warp_place[from];
    const float x0 = (float)p.x;
    const float y0 = (float)p.y;
    const float x1 = (float)(p.x + p.z);
    const float y1 = (float)(p.y + p.w);
    const T* v = raw + ((int64_t)b * cells + i) * 5;
    const int gy = i / side_n;
    const int gx = i - gy * side_n;
    const float cx = ((float)gx + sigmoid(to_float(v[1]))) * cell;
    const float cy = ((float)gy + sigmoid(to_float(v[2]))) * cell;
    if (cx >= x0 && cx < x1 && cy >= y0 && cy < y1) {
      const float bw =
          expf(fminf(fmaxf(to_float(v[3]), -6.0f), 6.0f)) * cell;
      const float bh =
          expf(fminf(fmaxf(to_float(v[4]), -6.0f), 6.0f)) * cell;
      o[0] = sigmoid(to_float(v[0]));
      o[1] = fminf(fmaxf(cx - bw / 2.0f, x0), x1) - x0;
      o[2] = fminf(fmaxf(cy - bh / 2.0f, y0), y1) - y0;
      o[3] = fminf(fmaxf(cx + bw / 2.0f, x0), x1) - x0;
      o[4] = fminf(fmaxf(cy + bh / 2.0f, y0), y1) - y0;
    }
  }
  float* dst = out + (int64_t)slot * cells * 5;
  if (kVec) {
    // the warp's cells, contiguous in the output: stage, then 16-byte
    // chunks l and l + 32 of the warp's span
    const int lane = threadIdx.x & 31;
    const int w0 = i - lane;  // the warp's first cell
    float* st = stage + (threadIdx.x - lane) * 5;
#pragma unroll
    for (int q = 0; q < 5; ++q) st[lane * 5 + q] = o[q];
    __syncwarp();
    const int chunks = min(32, cells - w0) * 5 / 4;
    for (int q = lane; q < chunks; q += 32) {
      reinterpret_cast<float4*>(dst + (int64_t)w0 * 5)[q] =
          reinterpret_cast<const float4*>(st)[q];
    }
  } else if (i < cells) {
#pragma unroll
    for (int q = 0; q < 5; ++q) dst[(int64_t)i * 5 + q] = o[q];
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
  dim3 grid(num_slots, (cells + kDecTile - 1) / kDecTile);
  const T* in = static_cast<const T*>(raw);
  if (cells % 4 == 0) {
    unstitch_decode_kernel<T, true><<<grid, kThreads, 0, stream>>>(
        in, records, out, b * k, k, side_m, side_n, (float)patch);
  } else {
    unstitch_decode_kernel<T, false><<<grid, kThreads, 0, stream>>>(
        in, records, out, b * k, k, side_m, side_n, (float)patch);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream`, never synchronise, allocate nothing
// and return a CUDA error code (0 on success).  `bf16` selects the weight
// (K4) or raw head (K3) type: 1 bfloat16, 0 float32.  `tile_n` is the bf16
// K4's column tile (192, 128 or 64; cudaErrorInvalidValue otherwise); the
// float32 K4 has one tile and ignores it.
extern "C" int tangram_stitch_embed(const void* slots, const int* records,
                                    const void* kernel, const void* bias,
                                    void* tokens, int hmax, int wmax, int c,
                                    int b, int k, int m, int n, int patch,
                                    int d, int bf16, int tile_n,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* px = static_cast<const float*>(slots);
  if (bf16) {
    switch (tile_n) {
      case 192:
        return launch_stitch_embed_wgmma<192>(px, records, kernel, bias,
                                              tokens, hmax, wmax, c, b, k, m,
                                              n, patch, d, s);
      case 128:
        return launch_stitch_embed_wgmma<128>(px, records, kernel, bias,
                                              tokens, hmax, wmax, c, b, k, m,
                                              n, patch, d, s);
      case 64:
        return launch_stitch_embed_wgmma<64>(px, records, kernel, bias,
                                             tokens, hmax, wmax, c, b, k, m,
                                             n, patch, d, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
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
