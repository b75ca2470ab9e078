// Batched multi-level RoIAlign feature gradient, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:244), launched by
// `batched_multilevel_roi_align_pallas_bwd` (pallas_roi_align.py:828).  It is
// the transpose of the forward kernel (roi_align_fwd.cu): for every RoI n
// and channel c it adds the window gradient
//
//     dwin[k, m, c] = sum_oy sum_ox wy[n, oy, k] * g[n, oy, ox, c] * wx[n, ox, m]
//
// into d_stacked[row0[n] + k, x0[n] + m, c], over the 24 x win_w window of
// the stacked pyramid, with the 2x2 bin mean folded into wy (7 x 24) and wx
// (7 x win_w).  RoIs with valid[n] == 0 add nothing.  The caller zeroes
// d_stacked and computes the geometry (boosting_rcnn_tpu_torch/ops/
// roi_align.py); autograd splits d_stacked back into the pyramid levels.
//
// What bounds it on an H100: bytes.  At the flagship's train shapes (B*R =
// 2048 sampled RoIs, C = 256) it reads the 103 MB cotangent once and the
// function writes the dense 151 MB stacked gradient, ~0.077 ms at 3.35 TB/s;
// its operations, counted on the nonzero interpolation taps only, are a
// few hundred MFLOP, ~0.01 ms at the float32 peak.
//
// Design: one block per (RoI, 64-channel tile), one thread per channel, as
// the forward.  Invalid RoIs return at once.  wy and wx go to shared
// memory, and thread 0 lists the window rows and columns that carry a
// nonzero weight (after the pool fold a row of wy or wx has at most a few
// nonzero taps, so these lists are short); all work stays inside them.
// Each thread loads its 49 cotangents into registers (coalesced: 64
// consecutive floats of the NHWC layout per load), and contracts ox first,
// then oy, as the TPU kernel does: for each listed column m it forms
// v[oy] = sum_ox g[oy][ox] * wx[ox][m] in 7 registers, then for each listed
// row k adds sum_oy wy[oy][k] * v[oy] with a float32 atomicAdd.  The 64
// threads of a block add to 64 consecutive floats, one coalesced 256-byte
// segment.  The TPU kernel's VMEM accumulator, row-split passes,
// pass-sorted indexed DMA, 128-lane packing and `x0 // align` shift are TPU
// layout rules and are dropped; none changes the numbers.  Atomics add in
// an order that changes from run to run, so the result is not bitwise
// repeatable (the TPU kernel is); a window-sorted deterministic design, and
// one that keeps neighbouring windows' sums in shared memory instead of
// issuing an atomic per cell, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;       // pooled output size
constexpr int kWin = 24;      // window rows (and the widest window)
constexpr int kThreads = 64;  // channels per block

__global__ void __launch_bounds__(kThreads)
roi_align_bwd_kernel(const float* __restrict__ g,
                     const int32_t* __restrict__ row0,
                     const int32_t* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ d_stacked,
                     int rows, int width, int channels, int win_w) {
  const int n = blockIdx.x;
  // the whole block takes the same branch, before any barrier
  if (!valid[n]) return;
  const int r0 = row0[n];
  const int c0 = x0[n];
  if (r0 < 0 || r0 + kWin > rows || c0 < 0 || c0 + win_w > width) return;

  __shared__ float s_wy[kOut][kWin];
  __shared__ float s_wx[kOut][kWin];
  __shared__ int s_rows[kWin];
  __shared__ int s_cols[kWin];
  __shared__ int s_nrows;
  __shared__ int s_ncols;
  for (int t = threadIdx.x; t < kOut * kWin; t += kThreads) {
    const int o = t / kWin;
    const int k = t % kWin;
    s_wy[o][k] = wy[static_cast<size_t>(n) * kOut * kWin + t];
    s_wx[o][k] = k < win_w
        ? wx[(static_cast<size_t>(n) * kOut + o) * win_w + k] : 0.0f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int nr = 0;
    int nc = 0;
    for (int k = 0; k < kWin; ++k) {
      bool row_used = false;
      bool col_used = false;
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        row_used |= s_wy[o][k] != 0.0f;
        col_used |= s_wx[o][k] != 0.0f;
      }
      if (row_used) s_rows[nr++] = k;
      if (col_used) s_cols[nc++] = k;
    }
    s_nrows = nr;
    s_ncols = nc;
  }
  __syncthreads();

  const int c = blockIdx.y * kThreads + threadIdx.x;
  if (c >= channels) return;

  float gr[kOut][kOut];
  const float* src = g + static_cast<size_t>(n) * kOut * kOut * channels + c;
#pragma unroll
  for (int oy = 0; oy < kOut; ++oy) {
#pragma unroll
    for (int ox = 0; ox < kOut; ++ox) {
      gr[oy][ox] = __ldg(src + static_cast<size_t>(oy * kOut + ox) * channels);
    }
  }

  const size_t row_stride = static_cast<size_t>(width) * channels;
  float* dst = d_stacked + static_cast<size_t>(r0) * row_stride
               + static_cast<size_t>(c0) * channels + c;
  const int nr = s_nrows;
  const int nc = s_ncols;
  for (int j = 0; j < nc; ++j) {
    const int m = s_cols[j];
    float v[kOut];
#pragma unroll
    for (int oy = 0; oy < kOut; ++oy) {
      float t = 0.0f;
#pragma unroll
      for (int ox = 0; ox < kOut; ++ox) t = fmaf(gr[oy][ox], s_wx[ox][m], t);
      v[oy] = t;
    }
    float* col = dst + static_cast<size_t>(m) * channels;
    for (int i = 0; i < nr; ++i) {
      const int k = s_rows[i];
      float acc = 0.0f;
#pragma unroll
      for (int oy = 0; oy < kOut; ++oy) acc = fmaf(s_wy[oy][k], v[oy], acc);
      atomicAdd(col + static_cast<size_t>(k) * row_stride, acc);
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors: g (n, 7, 7, channels) f32, row0 and x0 (n,) int32,
// wy (n, 7, 24) f32, wx (n, 7, win_w) f32, valid (n,) uint8, d_stacked
// (rows, width, channels) f32, which the kernel adds into.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); shapes it does not
// take give cudaErrorInvalidValue without a launch.
extern "C" int roi_align_bwd_f32(const void* g, const void* row0,
                                 const void* x0, const void* wy,
                                 const void* wx, const void* valid,
                                 void* d_stacked, int n, int rows, int width,
                                 int channels, int win_w, int out_size,
                                 int win, void* stream) {
  if (out_size != kOut || win != kWin || win_w < 1 || win_w > kWin ||
      win_w > width || rows < kWin || channels < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n, (channels + kThreads - 1) / kThreads);
  roi_align_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(x0), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<const uint8_t*>(valid),
      static_cast<float*>(d_stacked), rows, width, channels, win_w);
  return static_cast<int>(cudaGetLastError());
}
