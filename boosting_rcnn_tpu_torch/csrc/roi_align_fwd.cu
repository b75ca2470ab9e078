// Batched multi-level RoIAlign forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_flat` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:586), launched by `batched_multilevel_roi_align_pallas`
// (pallas_roi_align.py:766).  For every RoI n and channel c it computes
//
//     out[n, py, px, c] = sum_i sum_j wy[n, py, i] * wx[n, px, j]
//                                     * stacked[row0[n] + i, x0[n] + j, c]
//
// over the 24 x win_w window of the stacked pyramid at (row0, x0), with the
// 2x2 bin mean already folded into wy (7 x 24) and wx (7 x win_w).  RoIs with
// valid[n] == 0 are written as zeros and read nothing.  The window geometry
// and the interpolation matrices are computed by the caller
// (boosting_rcnn_tpu_torch/ops/roi_align.py).
//
// What bounds it on an H100: at the flagship's shapes (B*R = 512 RoIs,
// C = 256) the function reads ~16 MB of pyramid cells (each cell that some
// RoI weights, once) and writes 25.7 MB, ~0.012 ms at 3.35 TB/s.  Its
// operations are few: after the pool fold each row of wy and wx has at most
// 4 nonzero taps, so it needs at most ~0.23 GFLOP (~0.003 ms at the float32
// peak), and bytes bind.  This kernel does more than that: it contracts the
// whole 7 x 24 x win_w window, zero taps included (~1.4 GFLOP, ~0.02 ms at
// the float32 peak), and reads each 0.59 MB window once per RoI (~0.3 GB in
// all, ~0.1 ms if every window came from HBM), leaving the overlap of
// neighbouring windows to the 50 MB L2.
//
// Design: one block per (RoI, 64-channel tile), one thread per channel, so
// that each window cell load is 64 consecutive floats of the NHWC layout
// (coalesced: 128 contiguous bytes per warp).  wy and wx go to shared
// memory once per block.  Each thread walks the 24 window rows: it loads
// the row's win_w values into registers, contracts them with the 7 rows of
// wx, and accumulates the 7 results into its 7 x 7 output tile with the
// row's wy column; all accumulation is in float32 registers.  No tensor
// cores: their float32 path is TF32, which would change the numbers, and
// the per-RoI products (7 x 24 x 24) are small.  Making it fast (one
// staged copy of each window shared by the channel tiles of a RoI,
// cp.async/TMA, bf16 windows) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kOut = 7;       // pooled output size
constexpr int kWin = 24;      // window rows (and the widest window)
constexpr int kThreads = 64;  // channels per block

__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const float* __restrict__ stacked,
                     const int32_t* __restrict__ row0,
                     const int32_t* __restrict__ x0,
                     const float* __restrict__ wy,
                     const float* __restrict__ wx,
                     const uint8_t* __restrict__ valid,
                     float* __restrict__ out,
                     int width, int channels, int win_w) {
  const int n = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;

  __shared__ float s_wy[kOut][kWin];
  __shared__ float s_wx[kOut][kWin];
  for (int t = threadIdx.x; t < kOut * kWin; t += kThreads) {
    const int o = t / kWin;
    const int k = t % kWin;
    s_wy[o][k] = wy[static_cast<size_t>(n) * kOut * kWin + t];
    s_wx[o][k] = k < win_w
        ? wx[(static_cast<size_t>(n) * kOut + o) * win_w + k] : 0.0f;
  }
  __syncthreads();
  if (c >= channels) return;

  float* dst = out + static_cast<size_t>(n) * kOut * kOut * channels + c;
  if (!valid[n]) {
#pragma unroll
    for (int p = 0; p < kOut * kOut; ++p) dst[static_cast<size_t>(p) * channels] = 0.0f;
    return;
  }

  float acc[kOut][kOut];
#pragma unroll
  for (int py = 0; py < kOut; ++py) {
#pragma unroll
    for (int px = 0; px < kOut; ++px) acc[py][px] = 0.0f;
  }

  const size_t row_stride = static_cast<size_t>(width) * channels;
  const float* src = stacked + static_cast<size_t>(row0[n]) * row_stride
                     + static_cast<size_t>(x0[n]) * channels + c;
  for (int i = 0; i < kWin; ++i) {
    const float* row = src + i * row_stride;
    float v[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      v[j] = j < win_w ? __ldg(row + static_cast<size_t>(j) * channels) : 0.0f;
    }
#pragma unroll
    for (int px = 0; px < kOut; ++px) {
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) t = fmaf(s_wx[px][j], v[j], t);
#pragma unroll
      for (int py = 0; py < kOut; ++py) acc[py][px] = fmaf(s_wy[py][i], t, acc[py][px]);
    }
  }

#pragma unroll
  for (int py = 0; py < kOut; ++py) {
#pragma unroll
    for (int px = 0; px < kOut; ++px) {
      dst[static_cast<size_t>(py * kOut + px) * channels] = acc[py][px];
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Pointers are device pointers of
// contiguous tensors: stacked (rows, width, channels) f32, row0 and x0 (n,)
// int32, wy (n, 7, 24) f32, wx (n, 7, win_w) f32, valid (n,) uint8, out
// (n, 7, 7, channels) f32.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); shapes it does not take give
// cudaErrorInvalidValue without a launch.
extern "C" int roi_align_fwd_f32(const void* stacked, const void* row0,
                                 const void* x0, const void* wy,
                                 const void* wx, const void* valid, void* out,
                                 int n, int width, int channels, int win_w,
                                 int out_size, int win, void* stream) {
  if (out_size != kOut || win != kWin || win_w < 1 || win_w > kWin ||
      win_w > width || channels < 1 || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(n, (channels + kThreads - 1) / kThreads);
  roi_align_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stacked), static_cast<const int32_t*>(row0),
      static_cast<const int32_t*>(x0), static_cast<const float*>(wy),
      static_cast<const float*>(wx), static_cast<const uint8_t*>(valid),
      static_cast<float*>(out), width, channels, win_w);
  return static_cast<int>(cudaGetLastError());
}
