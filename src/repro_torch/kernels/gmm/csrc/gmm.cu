// Stauffer-Grimson GMM background update (K5) for Hopper (sm_90a).
//
// Replaces the TPU kernel gmm_update_pallas (_gmm_kernel) in
// src/repro/kernels/gmm/gmm.py:72 (body :26-69): one streaming update of a
// per-pixel 3-component Gaussian mixture over luminance, and the pixel's
// foreground bit.
//
// Layouts (row-major, contiguous, float32 unless noted):
//   w, mu, var          (H, W, 3)  state in, read once
//   frame               (H, W)
//   w_out, mu_out, var_out (H, W, 3)  new state, written once (out of place)
//   fg                  (H, W) bool, one byte a pixel (0 or 1)
//
// Bound on an H100: a pixel moves 36 B of state in, 4 B of frame, 36 B of
// state out and 1 B of mask, 77 B in all: 638.7 MB for a 3840x2160 frame,
// 0.191 ms at 3.35 TB/s (161.5 MB, 0.048 ms at 2048x1024).  Its ~100 float32
// operations come to 0.012 ms at 67 TFLOP/s for a 4K frame, so the kernel is
// bound by bytes.
//
// Design.  The Pallas kernel streams (8, 512) pixel tiles through VMEM and
// needs H % 8 == 0 and W % 512 == 0, which a 3840-wide frame breaks.  Here one
// thread owns one pixel of the flat H*W index, keeps its three components in
// registers, and the ragged tail is masked, so any H and W work.  The state
// keeps the reference's (H, W, 3) layout: neighbouring threads read
// neighbouring 12-byte groups, so a warp's loads cover 384 contiguous bytes
// of each array.  16-byte vector access and an in-place update (which would
// halve the allocations, not the bytes) are left to a later change.
//
// Rounding.  The kernel must equal the plain PyTorch version
// (repro_torch/core/gmm.py::update) bit for bit.  That version rounds every
// op once in float32, so every product, sum, quotient and square root here
// is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn, __fsqrt_rn), which nvcc never contracts into an FMA.  The
// constants arrive already rounded to float32 the way PyTorch rounds a
// Python scalar, and the two sums over components are left folds in index
// order, as the plain version writes them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kK = 3;

struct Consts {
  float keep;        // 1 - learning_rate
  float lr;          // learning_rate
  float sigmas2;     // match_sigmas ** 2
  float min_var;
  float init_var;
  float bg_ratio;    // background_ratio
};

__global__ void __launch_bounds__(kThreads)
gmm_kernel(const float* __restrict__ w_in, const float* __restrict__ mu_in,
           const float* __restrict__ var_in, const float* __restrict__ frame,
           float* __restrict__ w_out, float* __restrict__ mu_out,
           float* __restrict__ var_out, uint8_t* __restrict__ fg_out,
           int64_t n_pixels, Consts c) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n_pixels) return;
  const float x = frame[p];
  float w[kK], mu[kK], var[kK], dist2[kK];
  bool matched[kK];
  bool any_match = false;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w[k] = w_in[p * kK + k];
    mu[k] = mu_in[p * kK + k];
    var[k] = var_in[p * kK + k];
    const float d = __fsub_rn(x, mu[k]);
    dist2[k] = __fmul_rn(d, d);
    matched[k] = dist2[k] < __fmul_rn(c.sigmas2, var[k]);
    any_match = any_match || matched[k];
  }

  // among matched components the first with the largest w / sqrt(var)
  int best = 0;
  float best_fit = -INFINITY;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float fit =
        matched[k] ? __fdiv_rn(w[k], __fsqrt_rn(var[k])) : -INFINITY;
    if (k == 0 || fit > best_fit) {
      best = k;
      best_fit = fit;
    }
  }
  // no match: the first component of least weight is replaced
  int weakest = 0;
#pragma unroll
  for (int k = 1; k < kK; ++k) {
    if (w[k] < w[weakest]) weakest = k;
  }

  float w_new[kK], mu_new[kK], var_new[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const bool hit = any_match && k == best;
    w_new[k] = __fadd_rn(__fmul_rn(c.keep, w[k]),
                         __fmul_rn(c.lr, hit ? 1.0f : 0.0f));
    mu_new[k] = hit ? __fadd_rn(__fmul_rn(c.keep, mu[k]), __fmul_rn(c.lr, x))
                    : mu[k];
    var_new[k] = hit ? fmaxf(__fadd_rn(__fmul_rn(c.keep, var[k]),
                                       __fmul_rn(c.lr, dist2[k])),
                             c.min_var)
                     : var[k];
    if (!any_match && k == weakest) {
      w_new[k] = c.lr;
      mu_new[k] = x;
      var_new[k] = c.init_var;
    }
  }
  const float total = __fadd_rn(__fadd_rn(w_new[0], w_new[1]), w_new[2]);
  float fit_new[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w_new[k] = __fdiv_rn(w_new[k], total);
    fit_new[k] = __fdiv_rn(w_new[k], __fsqrt_rn(var_new[k]));
  }

  // a component is background when the weight of the components fitter
  // than it (ties: lower index first) is below the ratio; the pixel is
  // foreground unless it matched a background component
  bool fg = true;
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    float cum_before = 0.0f;
#pragma unroll
    for (int j = 0; j < kK; ++j) {
      const bool fitter = fit_new[j] > fit_new[i] ||
                          (fit_new[j] == fit_new[i] && j < i);
      const float part = fitter ? w_new[j] : 0.0f;
      cum_before = j == 0 ? part : __fadd_rn(cum_before, part);
    }
    if (matched[i] && cum_before < c.bg_ratio) fg = false;
  }

#pragma unroll
  for (int k = 0; k < kK; ++k) {
    w_out[p * kK + k] = w_new[k];
    mu_out[p * kK + k] = mu_new[k];
    var_out[p * kK + k] = var_new[k];
  }
  fg_out[p] = fg ? 1 : 0;
}

}  // namespace

// Launches on `stream`, never synchronises, and returns cudaGetLastError()
// (0 on success).  The caller allocates every buffer and passes each
// constant already rounded to float32.
extern "C" int tangram_gmm_update(const float* w, const float* mu,
                                  const float* var, const float* frame,
                                  float* w_out, float* mu_out,
                                  float* var_out, uint8_t* fg,
                                  long long n_pixels, float keep, float lr,
                                  float sigmas2, float min_var,
                                  float init_var, float bg_ratio,
                                  void* stream) {
  if (n_pixels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Consts c{keep, lr, sigmas2, min_var, init_var, bg_ratio};
  const long long blocks = (n_pixels + kThreads - 1) / kThreads;
  gmm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      w, mu, var, frame, w_out, mu_out, var_out, fg, n_pixels, c);
  return static_cast<int>(cudaGetLastError());
}
