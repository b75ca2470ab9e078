// Batched multi-level RoIAlign feature gradient, float32, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:244), launched by
// `batched_multilevel_roi_align_pallas_bwd` (pallas_roi_align.py:828).  It is
// the transpose of the forward (roi_align_fwd.cu): for every valid RoI n of
// image b and channel c the window gradient
//
//     d[b, wy0 + k, wx0 + m, c] += sum_py sum_px wy[py, k] * wx[px, m] * g[n, py, px, c]
//
// summed over the RoIs, into the gradient of each route level, (batch, h, w,
// channels) f32.  The geometry is recomputed from the RoIs
// (roi_geometry.cuh).  Invalid RoIs add nothing, whatever their cotangent.
//
// What bounds it on an H100: bytes.  At the flagship's train shapes (B*R =
// 2048 sampled RoIs, C = 256) it reads the 103 MB cotangent and writes the
// 91.75 MB gradient of the five levels, ~0.058 ms at 3.35 TB/s; its
// operations, on the nonzero taps only, are ~0.2 GFLOP, ~0.003 ms at the
// float32 peak.
//
// Design: deterministic, without float atomics and without a separate zero
// fill of the gradient.  The levels are cut into 8 x 8-cell tiles.  A first
// kernel (roi_tile_keys_kernel) computes each valid RoI's geometry once,
// stores it (a Geom, 1.5 KB) and marks the RoI in the bitmap of every tile
// that its nonzero taps meet (at most 4 x 4 tiles) with an integer atomicOr,
// whose result does not depend on the order.  Then one block per (tile, 256
// channels): 8 warps, one per tile row; lane l takes the channel quads l and
// l + 32 (each load and store of a warp one contiguous 512 bytes), and the
// row's 8 cells x 8 channels of sums stay in registers.  Warp 0 turns the
// tile's bitmap into the list of its RoIs in ascending order in shared
// memory; the block walks it 16 RoIs at a time, their geometry copied into
// shared memory with cp.async, and finds once per RoI the y bins that meet
// each tile row and the x bins that meet the tile.  For its row y, each warp
// takes those x bins two at a time (their cotangent loads in flight
// together), forms h = sum_py wy[py, y] * g[n, py, px] and adds wx[px, x] * h
// to the cells x of the bin's nonzero taps.  Each cell and channel belongs
// to one thread, which adds its RoIs in ascending order, bins in a fixed
// order: the same sum, bit for bit, in every run, as the TPU kernel's
// sequential accumulation.  Last, every cell of the tile inside the level is
// stored once, zeros where no RoI reaches.  The 8 x 8 sums take 64 registers
// of a thread, so the kernel is held to 128 registers (2 blocks, 16 warps an
// SM): what bounds it in practice is the latency of the cotangent loads at
// that occupancy, and each bin's cotangent is read once per tile row that
// its taps reach (2-3 times), from L1 after the first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_geometry.cuh"

namespace {

using namespace roi;

constexpr int kKeyWarps = 4;                 // RoIs per block of the key kernel
constexpr int kLanes = 32;                   // lanes along the channels, 8 channels each
constexpr int kChannels = kLanes * 8;        // channels per block
constexpr int kWarps = kTile;                // one warp per tile row
constexpr int kThreads = kWarps * kLanes;
constexpr int kChunk = 16;                   // RoIs whose geometry is staged at once
constexpr int kBins = kOut * kOut;
constexpr int kWordsPerLane = 2;
constexpr int kListWords = 32 * kWordsPerLane;  // bitmap words listed at a time

// 16-byte copy from device to shared memory, asynchronous on the card.
__device__ inline void copy16(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
#else
  *static_cast<int4*>(smem) = *static_cast<const int4*>(gmem);
#endif
}

__device__ inline void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
#endif
}

__device__ inline void fma4(float4& acc, float w, const float4& v) {
  acc.x = fmaf(w, v.x, acc.x);
  acc.y = fmaf(w, v.y, acc.y);
  acc.z = fmaf(w, v.z, acc.z);
  acc.w = fmaf(w, v.w, acc.w);
}

__global__ void __launch_bounds__(kKeyWarps * 32)
roi_tile_keys_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                     const Levels L, int n_rois, int rois_per_img, Geom* __restrict__ geo,
                     unsigned* __restrict__ bitmap) {
  __shared__ Geom gs[kKeyWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kKeyWarps + warp;
  if (n >= n_rois || !valid[n]) return;  // whole warps only; no block barrier below
  Geom* g = &gs[warp];
  roi_geometry(rois, n, rois_per_img, L, g);
  const int4* src = reinterpret_cast<const int4*>(g);
  int4* dst = reinterpret_cast<int4*>(geo + n);
  for (int v = lane; v < kGeomVecs; v += 32) dst[v] = src[v];
  if (lane < kMaxTiles) {
    int ylo = kWin, yhi = -1, xlo = kWin, xhi = -1;
    for (int o = 0; o < kOut; ++o) {
      ylo = min(ylo, g->ylo[o]);
      yhi = max(yhi, g->yhi[o]);
      xlo = min(xlo, g->xlo[o]);
      xhi = max(xhi, g->xhi[o]);
    }
    const int ty = (g->wy0 + ylo) / kTile + lane / kTilesPerAxis;
    const int tx = (g->wx0 + xlo) / kTile + lane % kTilesPerAxis;
    if (ty <= (g->wy0 + yhi) / kTile && tx <= (g->wx0 + xhi) / kTile) {
      const int tile = g->img * L.tiles_per_img + L.tile_base[g->level] +
                       ty * L.tiles_x[g->level] + tx;
      const int words = (n_rois + 31) / 32;
      atomicOr(bitmap + static_cast<size_t>(tile) * words + n / 32, 1u << (n % 32));
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
roi_align_bwd_kernel(const float4* __restrict__ grad_out, const Geom* __restrict__ geo,
                     const unsigned* __restrict__ bitmap, int n_rois, const Levels L,
                     int quads) {
  __shared__ Geom gs[kChunk];
  __shared__ int2 bins_y[kChunk][kTile];  // per RoI and tile row: its y bins py0..py1
  __shared__ int2 bins_x[kChunk];         // per RoI: the x bins that meet the tile
  __shared__ int list[kListWords * 32];
  __shared__ int list_len;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qbase = static_cast<int>(blockIdx.y) * (kChannels / 4);
  const int q0 = qbase + lane;  // this lane's two channel quads: q0 and q0 + 32
  const bool has0 = q0 < quads;
  const bool has1 = q0 + kLanes < quads;

  const int img = tile / L.tiles_per_img;
  int rem = tile - img * L.tiles_per_img;
  int l = 0;
  while (l + 1 < L.n && rem >= L.tile_base[l + 1]) ++l;
  rem -= L.tile_base[l];
  const int y0 = (rem / L.tiles_x[l]) * kTile;
  const int x0 = (rem % L.tiles_x[l]) * kTile;
  const int y = y0 + warp;
  const int words = (n_rois + 31) / 32;
  const unsigned* bits = bitmap + static_cast<size_t>(tile) * words;

  float4 acc0[kTile], acc1[kTile];
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    acc0[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    acc1[j] = acc0[j];
  }

  for (int w0 = 0; w0 < words; w0 += kListWords) {
    // warp 0 lists the RoIs of bitmap words w0.. in ascending order
    if (warp == 0) {
      unsigned word[kWordsPerLane];
      int cnt = 0;
#pragma unroll
      for (int k = 0; k < kWordsPerLane; ++k) {
        const int w = w0 + lane * kWordsPerLane + k;
        word[k] = w < words ? bits[w] : 0u;
        cnt += __popc(word[k]);
      }
      int pos = cnt;  // inclusive scan over the lanes
      for (int d = 1; d < 32; d *= 2) {
        const int up = __shfl_up_sync(0xffffffffu, pos, d);
        if (lane >= d) pos += up;
      }
      if (lane == 31) list_len = pos;
      pos -= cnt;
#pragma unroll
      for (int k = 0; k < kWordsPerLane; ++k) {
        const int base = (w0 + lane * kWordsPerLane + k) * 32;
        for (unsigned rest = word[k]; rest; rest &= rest - 1) {
          list[pos++] = base + __ffs(static_cast<int>(rest)) - 1;
        }
      }
    }
    __syncthreads();
    const int len = list_len;
    for (int c0 = 0; c0 < len; c0 += kChunk) {
      const int count = min(kChunk, len - c0);
      for (int t = threadIdx.x; t < count * kGeomVecs; t += kThreads) {
        const int i = t / kGeomVecs;
        const int v = t - i * kGeomVecs;
        copy16(reinterpret_cast<int4*>(&gs[i]) + v,
               reinterpret_cast<const int4*>(geo + list[c0 + i]) + v);
      }
      copies_done();
      __syncthreads();
      // the bins that meet each row of the tile, and its columns, once per
      // RoI (the bins' nonzero ranges are ordered along each axis)
      if (threadIdx.x < count * (kTile + 1)) {
        const int i = threadIdx.x / (kTile + 1);
        const int r = threadIdx.x % (kTile + 1);
        const Geom& g = gs[i];
        int lo = kOut;
        int hi = -1;
        for (int o = 0; o < kOut; ++o) {
          const bool meets = r < kTile
              ? g.ylo[o] <= y0 + r - g.wy0 && y0 + r - g.wy0 <= g.yhi[o]
              : g.xhi[o] >= x0 - g.wx0 && g.xlo[o] <= x0 + kTile - 1 - g.wx0;
          if (meets) {
            lo = min(lo, o);
            hi = o;
          }
        }
        if (r < kTile) bins_y[i][r] = make_int2(lo, hi); else bins_x[i] = make_int2(lo, hi);
      }
      __syncthreads();
      for (int i = 0; i < count && has0; ++i) {
        const Geom& g = gs[i];
        const int ky = y - g.wy0;
        const int pylo = bins_y[i][warp].x;
        const int pyhi = bins_y[i][warp].y;
        if (pyhi < 0) continue;
        const int kx0 = x0 - g.wx0;
        const float4* gn = grad_out + static_cast<size_t>(g.n) * kBins * quads + q0;
        const int pxa = bins_x[i].x;
        const int pxb = bins_x[i].y;
        // two x bins at a time, so that their loads are in flight together
        for (int px = pxa; px <= pxb; px += 2) {
          const bool two = px + 1 <= pxb;
          float4 h[2][2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            h[e][0] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            h[e][1] = h[e][0];
          }
#pragma unroll 2
          for (int py = pylo; py <= pyhi; ++py) {
            const float a = g.wy[py][ky];
            const float4* src = gn + (py * kOut + px) * quads;
            const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float4 v00 = __ldg(src);
            const float4 v01 = has1 ? __ldg(src + kLanes) : zero;
            const float4 v10 = two ? __ldg(src + quads) : zero;
            const float4 v11 = two && has1 ? __ldg(src + quads + kLanes) : zero;
            fma4(h[0][0], a, v00);
            fma4(h[0][1], a, v01);
            fma4(h[1][0], a, v10);
            fma4(h[1][1], a, v11);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 1 && !two) break;
            const int xlo = max(g.xlo[px + e], kx0);
            const int xhi = min(g.xhi[px + e], kx0 + kTile - 1);
#pragma unroll
            for (int j = 0; j < kTile; ++j) {
              const int kx = kx0 + j;
              if (kx < xlo || kx > xhi) continue;
              const float w = g.wx[px + e][kx];
              fma4(acc0[j], w, h[e][0]);
              fma4(acc1[j], w, h[e][1]);
            }
          }
        }
      }
      __syncthreads();
    }
    __syncthreads();  // every warp has read list_len before warp 0 rewrites it
  }

  const Level lv = L.lv[l];
  if (y >= lv.h || !has0) return;
  float* row = lv.base + img * lv.s_img + y * lv.s_row + 4 * q0;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (x0 + j < lv.w) {
      float4* dst = reinterpret_cast<float4*>(row + (x0 + j) * lv.s_col);
      dst[0] = acc0[j];
      if (has1) dst[kLanes] = acc1[j];
    }
  }
}

}  // namespace

// Plain C entry points, loaded with ctypes.  The level arguments are host
// arrays, one entry per route level, as for roi_align_fwd_f32: level_ptrs
// (device pointers; the gradients here, (batch, h, w, channels) f32 with
// unit channel stride; may be null for the key kernel), level_h, level_w,
// level_strides (image, row, column, in elements), inv_strides.  rois
// (batch * rois_per_img, 4) f32 and valid (batch * rois_per_img,) uint8 are
// device pointers.  Each launches on `stream` and returns cudaGetLastError()
// (0 on success); shapes it does not take give cudaErrorInvalidValue
// without a launch.

// sizeof(Geom), for the caller that allocates geo.
extern "C" int roi_geom_bytes() { return static_cast<int>(sizeof(Geom)); }

// geo (batch * rois_per_img,) Geom (1488 bytes each, 16-byte aligned): each
// valid RoI's geometry; bitmap (batch * tiles_per_img, ceil(batch *
// rois_per_img / 32)) uint32: bit n of tile t's row is set when valid RoI n
// meets tile t (image * tiles_per_img + tile_base[level] + ty *
// tiles_x[level] + tx).  The bitmap is zeroed on `stream` first.
extern "C" int roi_tile_keys(const void* rois, const void* valid, void* geo, void* bitmap,
                             int batch, int rois_per_img, float finest_scale, int num_levels, const long long* levels, void* stream) {
  Levels L;
  if (batch < 1 || rois_per_img < 1 || reinterpret_cast<uintptr_t>(geo) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = batch * rois_per_img;
  const size_t bitmap_bytes =
      static_cast<size_t>(batch) * L.tiles_per_img * ((n + 31) / 32) * sizeof(unsigned);
  const cudaError_t zeroed =
      cudaMemsetAsync(bitmap, 0, bitmap_bytes, static_cast<cudaStream_t>(stream));
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  roi_tile_keys_kernel<<<(n + kKeyWarps - 1) / kKeyWarps, kKeyWarps * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rois), static_cast<const uint8_t*>(valid), L, n, rois_per_img,
      static_cast<Geom*>(geo), static_cast<unsigned*>(bitmap));
  return static_cast<int>(cudaGetLastError());
}

// g (batch * rois_per_img, 7, 7, channels) f32: the cotangent; geo and
// bitmap: roi_tile_keys' output for the same RoIs.  Writes every cell of
// every level gradient.
extern "C" int roi_align_bwd_f32(const void* g, const void* geo, const void* bitmap,
                                 int batch, int rois_per_img, int channels,
                                 float finest_scale, int num_levels, const long long* levels, void* stream) {
  Levels L;
  if (batch < 1 || rois_per_img < 1 || channels < 4 || channels % 4 ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(geo) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < num_levels; ++l) {
    if (L.lv[l].base == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quads = channels / 4;
  const dim3 grid(batch * L.tiles_per_img, (channels + kChannels - 1) / kChannels);
  roi_align_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(g), static_cast<const Geom*>(geo),
      static_cast<const unsigned*>(bitmap), batch * rois_per_img, L, quads);
  return static_cast<int>(cudaGetLastError());
}
