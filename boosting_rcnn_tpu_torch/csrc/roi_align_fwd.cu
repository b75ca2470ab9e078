// Batched multi-level RoIAlign forward, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel_flat` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:586), launched by `batched_multilevel_roi_align_pallas`
// (pallas_roi_align.py:766).  For every RoI n of image b and channel c it
// computes the 7 x 7 pooled output
//
//     out[n, py, px, c] = sum_k sum_m wy[py, k] * wx[px, m]
//                                     * level[b, wy0 + k, wx0 + m, c]
//
// over the RoI's 24 x win_w window of its pyramid level, with wy and wx the
// bilinear weights of the bin's two samples per axis averaged (the 2 x 2 bin
// mean folded in).  The level, the window and the weights come from the RoI
// in the kernel itself (roi_geometry.cuh).  RoIs with valid[n] == 0 are
// written as zeros and read nothing.
//
// What bounds it on an H100: bytes.  At the flagship's predict shapes (B*R =
// 512 RoIs, C = 256) the function reads ~16 MB of level cells (each cell
// that some RoI weights, once) and writes 25.7 MB, ~0.012 ms at 3.35 TB/s;
// its operations, on the nonzero taps only, take a few microseconds at the
// float32 peak.
//
// Design: one block per RoI, 256 threads: 64 threads along the channels,
// each loading float4 (one 1 KB coalesced row of 256 channels per cell
// across the 64 threads), times 4 groups that share the 49 bins.  Warp 0
// computes the RoI's geometry into shared memory first.  Each bin then reads
// only the cells of its nonzero taps (2 x 2 samples, 2 x 2 taps each, on
// 2-4 distinct rows and columns) and accumulates in float32 registers; the
// bins of one RoI share cells, which L1 serves.  The levels are read in
// place (NHWC, unit channel stride; the wrapper passes their strides), so
// there is no stacked copy of the pyramid and no geometry pass before the
// kernel.  No tensor cores: their float32 path is TF32, which would change
// the numbers, and each bin is a handful of products.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_geometry.cuh"

namespace {

using namespace roi;

constexpr int kQuads = 64;   // threads along the channels, 4 channels each
constexpr int kGroups = 4;   // thread groups that share the bins
constexpr int kThreads = kQuads * kGroups;

__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                     const Levels L, int rois_per_img, int quads,
                     float4* __restrict__ out) {
  const int n = blockIdx.x;
  const int q0 = threadIdx.x % kQuads;
  const int group = threadIdx.x / kQuads;
  float4* dst = out + static_cast<size_t>(n) * kOut * kOut * quads;
  if (!valid[n]) {  // the same branch for the whole block, before any barrier
    for (int b = group; b < kOut * kOut; b += kGroups) {
      for (int q = q0; q < quads; q += kQuads) {
        dst[static_cast<size_t>(b) * quads + q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    return;
  }

  __shared__ Geom g;
  if (threadIdx.x < 32) roi_geometry(rois, n, rois_per_img, L, &g);
  __syncthreads();

  const Level lv = L.lv[g.level];
  const float* win = lv.base + g.img * lv.s_img + g.wy0 * lv.s_row + g.wx0 * lv.s_col;
  for (int b = group; b < kOut * kOut; b += kGroups) {
    const int py = b / kOut;
    const int px = b % kOut;
    const int ylo = g.ylo[py], yhi = g.yhi[py];
    const int xlo = g.xlo[px], xhi = g.xhi[px];
    for (int q = q0; q < quads; q += kQuads) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int k = ylo; k <= yhi; ++k) {
        const float a = g.wy[py][k];
        if (a == 0.0f) continue;
        const float* row = win + k * lv.s_row + 4 * q;
        float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int m = xlo; m <= xhi; ++m) {
          const float c = g.wx[px][m];
          if (c == 0.0f) continue;
          const float4 v = __ldg(reinterpret_cast<const float4*>(row + m * lv.s_col));
          t.x = fmaf(c, v.x, t.x);
          t.y = fmaf(c, v.y, t.y);
          t.z = fmaf(c, v.z, t.z);
          t.w = fmaf(c, v.w, t.w);
        }
        acc.x = fmaf(a, t.x, acc.x);
        acc.y = fmaf(a, t.y, acc.y);
        acc.z = fmaf(a, t.z, acc.z);
        acc.w = fmaf(a, t.w, acc.w);
      }
      dst[static_cast<size_t>(b) * quads + q] = acc;
    }
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Device pointers of contiguous
// tensors: rois (batch * rois_per_img, 4) f32, valid (batch * rois_per_img,)
// uint8, out (batch * rois_per_img, 7, 7, channels) f32.  levels: a host
// array of 7 int64 per route level (roi_geometry.cuh, fill_levels), the
// level (batch, h, w, channels) f32 with unit channel stride.  Launches on
// `stream` and returns cudaGetLastError() (0 on success); shapes it does not
// take give cudaErrorInvalidValue without a launch.
extern "C" int roi_align_fwd_f32(const void* rois, const void* valid, void* out, int batch,
                                 int rois_per_img, int channels, float finest_scale,
                                 int num_levels, const long long* levels, void* stream) {
  Levels L;
  if (batch < 1 || rois_per_img < 1 || channels < 4 || channels % 4 ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roi_align_fwd_kernel<<<batch * rois_per_img, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rois), static_cast<const uint8_t*>(valid), L, rois_per_img,
      channels / 4, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
