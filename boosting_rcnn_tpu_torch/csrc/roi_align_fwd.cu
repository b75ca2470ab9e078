// Batched multi-level RoIAlign forward, float32 and bfloat16, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel `_kernel_flat` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:586), launched by `batched_multilevel_roi_align_pallas`
// (pallas_roi_align.py:766).  For every RoI n of image b and channel c it
// computes the kOut x kOut pooled output (kOut = 7 for the box branch, 14
// for the mask branch: one instantiation and one entry point each)
//
//     out[n, py, px, c] = sum_k sum_m wy[py, k] * wx[px, m]
//                                     * level[b, wy0 + k, wx0 + m, c]
//
// over the RoI's 24 x win_w window of its pyramid level, with wy and wx the
// bilinear weights of the bin's two samples per axis averaged (the 2 x 2 bin
// mean folded in).  The level, the window and the weights come from the RoI
// in the kernel itself (roi_geometry.cuh).  RoIs with valid[n] == 0 are
// written as zeros and read nothing.  The output has the pyramid's type.
// In bfloat16 the arithmetic is the Pallas kernel's: the weights rounded
// to bfloat16 before and after the pool fold (roi_geometry.cuh), the cells
// widened to float32, both contractions summed in float32, rows first as
// the Pallas kernel's first dot (pallas_roi_align.py:653, :658), and one
// rounding of the output (:665).
//
// What bounds it on an H100: bytes.  At the flagship's predict shapes (B*R =
// 512 RoIs, C = 256) the float32 function reads ~16 MB of level cells (each
// cell that some RoI weights, once) and writes 25.7 MB, ~0.012 ms at
// 3.35 TB/s; in bfloat16 both halve.  At 14 x 14 each RoI writes 4x the
// output: Mask R-CNN's 1024 train mask RoIs write 205 MB in float32, so the
// writes set the bound.  Its operations, on the nonzero taps only, take a
// few microseconds at the float32 peak.
//
// Design: one block per RoI, 256 threads: along the channels, threads that
// each load 16 bytes (4 float or 8 bfloat16 channels; 64 or 32 threads,
// one coalesced row of 256 channels per cell), times 4 or 8 groups that
// share the kOut^2 bins (49 or 196).  Warp 0 computes the RoI's geometry into shared
// memory first.  Each bin then reads only the cells of its nonzero taps
// (2 x 2 samples, 2 x 2 taps each, on 2-4 distinct rows and columns) and
// accumulates in float32 registers, a column's rows first; the
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

constexpr int kThreads = 256;
constexpr int kRowChannels = 256;  // channels of one cell row across the threads

template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads)
roi_align_fwd_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                     const Levels L, int rois_per_img, int channels, T* __restrict__ out) {
  constexpr int kW = Pack<T>::kWidth;
  constexpr int kLanes = kRowChannels / kW;  // threads along the channels
  constexpr int kGroups = kThreads / kLanes;  // thread groups that share the bins
  const int n = blockIdx.x;
  const int v0 = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int vecs = channels / kW;
  T* dst = out + static_cast<size_t>(n) * kOut * kOut * channels;
  if (!valid[n]) {  // the same branch for the whole block, before any barrier
    const float zero[kW] = {};
    for (int b = group; b < kOut * kOut; b += kGroups) {
      for (int v = v0; v < vecs; v += kLanes) Pack<T>::store(dst + b * channels + kW * v, zero);
    }
    return;
  }

  __shared__ Geom<kOut> g;
  if (threadIdx.x < 32) roi_geometry<sizeof(T) == 2, kOut>(rois, n, rois_per_img, L, &g);
  __syncthreads();

  const Level lv = L.lv[g.level];
  const T* win = static_cast<const T*>(lv.base) + g.img * lv.s_img + g.wy0 * lv.s_row +
                 g.wx0 * lv.s_col;
  for (int b = group; b < kOut * kOut; b += kGroups) {
    const int py = b / kOut;
    const int px = b % kOut;
    const int ylo = g.ylo[py], yhi = g.yhi[py];
    const int xlo = g.xlo[px], xhi = g.xhi[px];
    for (int v = v0; v < vecs; v += kLanes) {
      float acc[kW] = {};
      for (int m = xlo; m <= xhi; ++m) {
        const float c = g.wx[px][m];
        if (c == 0.0f) continue;
        const T* col = win + m * lv.s_col + kW * v;
        float t[kW] = {};
        for (int k = ylo; k <= yhi; ++k) {
          const float a = g.wy[py][k];
          if (a == 0.0f) continue;
          float x[kW];
          Pack<T>::load(col + k * lv.s_row, x);
#pragma unroll
          for (int i = 0; i < kW; ++i) t[i] = fmaf(a, x[i], t[i]);
        }
#pragma unroll
        for (int i = 0; i < kW; ++i) acc[i] = fmaf(c, t[i], acc[i]);
      }
      Pack<T>::store(dst + b * channels + kW * v, acc);
    }
  }
}

template <typename T, int kOut>
int launch(const void* rois, const void* valid, void* out, int batch, int rois_per_img,
           int channels, float finest_scale, int num_levels, const long long* levels,
           void* stream) {
  constexpr int kW = Pack<T>::kWidth;
  Levels L;
  if (batch < 1 || rois_per_img < 1 || channels < kW || channels % kW ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  roi_align_fwd_kernel<T, kOut><<<batch * rois_per_img, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rois), static_cast<const uint8_t*>(valid), L, rois_per_img,
      channels, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  Device pointers of contiguous
// tensors: rois (batch * rois_per_img, 4) f32, valid (batch * rois_per_img,)
// uint8, out (batch * rois_per_img, k, k, channels) in the levels' type,
// k = 7 for the entries without a size suffix, 14 for the _o14 ones.
// levels: a host array of 7 int64 per route level (roi_geometry.cuh,
// fill_levels), the level (batch, h, w, channels) with unit channel stride.
// channels is a multiple of 4 (float) or 8 (bfloat16).  Launches on
// `stream` and returns cudaGetLastError() (0 on success); shapes it does
// not take give cudaErrorInvalidValue without a launch.
#define ROI_ALIGN_FWD_ENTRY(name, T, k)                                                   \
  extern "C" int name(const void* rois, const void* valid, void* out, int batch,          \
                      int rois_per_img, int channels, float finest_scale, int num_levels, \
                      const long long* levels, void* stream) {                            \
    return launch<T, k>(rois, valid, out, batch, rois_per_img, channels, finest_scale,    \
                        num_levels, levels, stream);                                      \
  }

ROI_ALIGN_FWD_ENTRY(roi_align_fwd_f32, float, 7)
ROI_ALIGN_FWD_ENTRY(roi_align_fwd_bf16, __nv_bfloat16, 7)
ROI_ALIGN_FWD_ENTRY(roi_align_fwd_f32_o14, float, 14)
ROI_ALIGN_FWD_ENTRY(roi_align_fwd_bf16_o14, __nv_bfloat16, 14)
