// Batched multi-level RoIAlign feature gradient, float32 and bfloat16, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:244), launched by
// `batched_multilevel_roi_align_pallas_bwd` (pallas_roi_align.py:828).  It is
// the transpose of the forward (roi_align_fwd.cu), for a kOut x kOut
// cotangent (kOut = 7 or 14, an instantiation and entry points each): for
// every valid RoI n of image b and channel c the window gradient
//
//     d[b, wy0 + k, wx0 + m, c] += sum_py sum_px wy[py, k] * wx[px, m] * g[n, py, px, c]
//
// summed over the RoIs, into the gradient of each route level, (batch, h, w,
// channels), in the type of the cotangent and the levels.  The geometry is
// recomputed from the RoIs (roi_geometry.cuh).  Invalid RoIs add nothing,
// whatever their cotangent.  In bfloat16 the arithmetic is the Pallas
// kernel's: the cotangent widened to float32 (pallas_roi_align.py:894),
// the weights rounded as the forward's (roi_geometry.cuh), float32 sums,
// and each cell rounded once to bfloat16 when it is stored (:919).
//
// What bounds it on an H100: bytes.  At the flagship's train shapes (B*R =
// 2048 sampled RoIs, C = 256) the float32 function reads the 103 MB
// cotangent and writes the 91.75 MB gradient of the five levels, ~0.058 ms
// at 3.35 TB/s; bfloat16 halves both.  Its operations, on the nonzero taps
// only, are ~0.2 GFLOP, ~0.003 ms at the float32 peak.  At 14 x 14 (Mask
// R-CNN's 1024 train mask RoIs) the cotangent is 205 MB in float32 and the
// gradient of P2-P5 at batch 2 ~183 MB: ~0.116 ms, bytes again.
//
// Design: deterministic, without float atomics and without a separate zero
// fill of the gradient.  The levels are cut into 8 x 8-cell tiles.  A first
// kernel (roi_tile_keys_kernel) computes each valid RoI's geometry once,
// stores it (a Geom, 1.5 KB at 7, 2.9 KB at 14) and marks the RoI in the
// bitmap of every tile that its nonzero taps meet (at most 4 x 4 tiles)
// with an integer atomicOr,
// whose result does not depend on the order.  Then one block per (tile, 256
// channels): 8 warps, one per tile row; lane l takes the channel quads l and
// l + 32 in float32, the 8 channels 8l..8l+7 in bfloat16 (each load and
// store of a warp one contiguous 512 bytes), and the
// row's 8 cells x 8 channels of sums stay in registers.  Warp 0 turns the
// tile's bitmap into the list of its RoIs in ascending order in shared
// memory; the block walks it kChunk RoIs at a time (16 at 7; 8 at 14, so
// that the staged geometry, 23 KB, and the list stay under the 48 KB of
// static shared memory), their geometry copied into shared memory with
// cp.async, and finds once per RoI the y bins that meet each tile row and
// the x bins that meet the tile.  For its row y, each warp
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
//
// Kept against a design that builds each tile's RoI list, with the y bins
// that meet each tile row and the x bins that meet the tile, in a pass
// before this kernel (a count per tile from the key kernel, a scan, a warp a
// tile), and walks it without the bitmap scan, the bin-range step or a block
// barrier, each warp staging its next RoI's Geom itself.  In bfloat16 at the
// flagship's train shapes (chip_smoke.py on a copy, NVIDIA H100 80GB HBM3,
// 700.00 W) that walk took 0.1080 ms and its list pass 0.0101 ms, against
// 0.0964-0.0968 ms for this kernel alone; it was slower at every timed
// shape, and so were its forms reading the weights through L1 and with 4
// cells or 4 channels a warp.  The chain it removes is a small part of a
// block; the walk, held by its cotangent loads at 16 warps an SM, is not
// changed by it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "roi_geometry.cuh"

namespace {

using namespace roi;

constexpr int kKeyWarps = 4;                 // RoIs per block of the key kernel
constexpr int kLanes = 32;                   // lanes along the channels, 8 channels each
constexpr int kLaneChannels = 8;
constexpr int kChannels = kLanes * kLaneChannels;  // channels per block
constexpr int kWarps = kTile;                // one warp per tile row
constexpr int kThreads = kWarps * kLanes;
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

// The 8 channels of lane l inside a block's 256: kParts runs of Pack<T>'s
// width, run p at channel kW * (l + 32 p) (float: 4l.. and 4(l + 32)..;
// bfloat16: 8l..), so that each run of a warp is one contiguous 512 bytes.
// A run at or past `width` (the block's channels) is not read or written.
template <typename T>
struct LaneChannels {
  static constexpr int kW = Pack<T>::kWidth;
  static constexpr int kParts = kLaneChannels / kW;
  __device__ static int offset(int lane, int p) { return kW * (lane + kLanes * p); }
  __device__ static void load(const T* base, int lane, int width, float* v) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      if (offset(lane, p) < width) {
        Pack<T>::load(base + offset(lane, p), v + kW * p);
      } else {
#pragma unroll
        for (int i = 0; i < kW; ++i) v[kW * p + i] = 0.0f;
      }
    }
  }
  __device__ static void store(T* base, int lane, int width, const float* v) {
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      if (offset(lane, p) < width) Pack<T>::store(base + offset(lane, p), v + kW * p);
    }
  }
};

__device__ inline void fma8(float* acc, float w, const float* v) {
#pragma unroll
  for (int i = 0; i < kLaneChannels; ++i) acc[i] = fmaf(w, v[i], acc[i]);
}

// RoIs whose geometry the gradient kernel stages in shared memory at once
template <int kOut>
constexpr int kChunk = kOut <= 7 ? 16 : 8;

template <bool kBf16Weights, int kOut>
__global__ void __launch_bounds__(kKeyWarps * 32)
roi_tile_keys_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                     const Levels L, int n_rois, int rois_per_img,
                     Geom<kOut>* __restrict__ geo, unsigned* __restrict__ bitmap) {
  __shared__ Geom<kOut> gs[kKeyWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n = blockIdx.x * kKeyWarps + warp;
  if (n >= n_rois || !valid[n]) return;  // whole warps only; no block barrier below
  Geom<kOut>* g = &gs[warp];
  roi_geometry<kBf16Weights, kOut>(rois, n, rois_per_img, L, g);
  const int4* src = reinterpret_cast<const int4*>(g);
  int4* dst = reinterpret_cast<int4*>(geo + n);
  for (int v = lane; v < kGeomVecs<kOut>; v += 32) dst[v] = src[v];
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

template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads, 2)
roi_align_bwd_kernel(const T* __restrict__ grad_out, const Geom<kOut>* __restrict__ geo,
                     const unsigned* __restrict__ bitmap, int n_rois, const Levels L,
                     int channels) {
  using Lane = LaneChannels<T>;
  constexpr int kStage = kChunk<kOut>;
  constexpr int kBins = kOut * kOut;
  __shared__ Geom<kOut> gs[kStage];
  __shared__ int2 bins_y[kStage][kTile];  // per RoI and tile row: its y bins py0..py1
  __shared__ int2 bins_x[kStage];         // per RoI: the x bins that meet the tile
  __shared__ int list[kListWords * 32];
  __shared__ int list_len;
  const int tile = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int cbase = static_cast<int>(blockIdx.y) * kChannels;
  const int width = min(kChannels, channels - cbase);  // this block's channels
  const bool has0 = Lane::offset(lane, 0) < width;

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

  float acc[kTile][kLaneChannels] = {};

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
    for (int c0 = 0; c0 < len; c0 += kStage) {
      const int count = min(kStage, len - c0);
      for (int t = threadIdx.x; t < count * kGeomVecs<kOut>; t += kThreads) {
        const int i = t / kGeomVecs<kOut>;
        const int v = t - i * kGeomVecs<kOut>;
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
        const Geom<kOut>& g = gs[i];
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
        const Geom<kOut>& g = gs[i];
        const int ky = y - g.wy0;
        const int pylo = bins_y[i][warp].x;
        const int pyhi = bins_y[i][warp].y;
        if (pyhi < 0) continue;
        const int kx0 = x0 - g.wx0;
        const T* gn = grad_out + static_cast<size_t>(g.n) * kBins * channels + cbase;
        const int pxa = bins_x[i].x;
        const int pxb = bins_x[i].y;
        // two x bins at a time, so that their loads are in flight together
        for (int px = pxa; px <= pxb; px += 2) {
          const bool two = px + 1 <= pxb;
          float h[2][kLaneChannels] = {};
#pragma unroll 2
          for (int py = pylo; py <= pyhi; ++py) {
            const float a = g.wy[py][ky];
            const T* src = gn + (py * kOut + px) * channels;
            float v0[kLaneChannels], v1[kLaneChannels];
            Lane::load(src, lane, width, v0);
            Lane::load(src + channels, lane, two ? width : 0, v1);
            fma8(h[0], a, v0);
            fma8(h[1], a, v1);
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
              fma8(acc[j], g.wx[px + e][kx], h[e]);
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
  T* row = static_cast<T*>(lv.base) + img * lv.s_img + y * lv.s_row + cbase;
#pragma unroll
  for (int j = 0; j < kTile; ++j) {
    if (x0 + j < lv.w) Lane::store(row + (x0 + j) * lv.s_col, lane, width, acc[j]);
  }
}

template <typename T, int kOut>
int launch_bwd(const void* g, const void* geo, const void* bitmap, int batch,
               int rois_per_img, int channels, float finest_scale, int num_levels,
               const long long* levels, void* stream) {
  constexpr int kW = Pack<T>::kWidth;
  Levels L;
  if (batch < 1 || rois_per_img < 1 || channels < kW || channels % kW ||
      reinterpret_cast<uintptr_t>(g) % 16 || reinterpret_cast<uintptr_t>(geo) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale, sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < num_levels; ++l) {
    if (L.lv[l].base == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(batch * L.tiles_per_img, (channels + kChannels - 1) / kChannels);
  roi_align_bwd_kernel<T, kOut><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(g), static_cast<const Geom<kOut>*>(geo),
      static_cast<const unsigned*>(bitmap), batch * rois_per_img, L, channels);
  return static_cast<int>(cudaGetLastError());
}

template <int kOut>
int tile_keys(const void* rois, const void* valid, void* geo, void* bitmap, int batch,
              int rois_per_img, int bf16_weights, float finest_scale, int num_levels,
              const long long* levels, void* stream) {
  Levels L;
  if (batch < 1 || rois_per_img < 1 || reinterpret_cast<uintptr_t>(geo) % 16 ||
      !fill_levels(&L, num_levels, levels, finest_scale, bf16_weights ? 2 : 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n = batch * rois_per_img;
  const size_t bitmap_bytes =
      static_cast<size_t>(batch) * L.tiles_per_img * ((n + 31) / 32) * sizeof(unsigned);
  const cudaError_t zeroed =
      cudaMemsetAsync(bitmap, 0, bitmap_bytes, static_cast<cudaStream_t>(stream));
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  const dim3 grid((n + kKeyWarps - 1) / kKeyWarps);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  Geom<kOut>* out = static_cast<Geom<kOut>*>(geo);
  unsigned* bits = static_cast<unsigned*>(bitmap);
  if (bf16_weights) {
    roi_tile_keys_kernel<true, kOut><<<grid, kKeyWarps * 32, 0, s>>>(r, v, L, n, rois_per_img,
                                                                     out, bits);
  } else {
    roi_tile_keys_kernel<false, kOut><<<grid, kKeyWarps * 32, 0, s>>>(r, v, L, n, rois_per_img,
                                                                      out, bits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes.  levels: a host array of 7
// int64 per route level, as for roi_align_fwd_f32 (roi_geometry.cuh,
// fill_levels); the level gradients here, (batch, h, w, channels) with
// unit channel stride, in the entry point's type (the key kernel reads
// only the shapes; its bases may be 0).  rois (batch * rois_per_img, 4)
// f32 and valid (batch * rois_per_img,) uint8 are device pointers.  Each
// launches on `stream` and returns cudaGetLastError() (0 on success);
// shapes it does not take give cudaErrorInvalidValue without a launch.
// The entries without a size suffix pool to 7 x 7, the _o14 ones to
// 14 x 14; the geometry and the cotangent of one call are of one size.

// sizeof(Geom) for the pooled size out_size (7 or 14; 0 for any other), for
// the caller that allocates geo.
extern "C" int roi_geom_bytes(int out_size) {
  return out_size == 7 ? static_cast<int>(sizeof(Geom<7>))
                       : out_size == 14 ? static_cast<int>(sizeof(Geom<14>)) : 0;
}

// geo (batch * rois_per_img,) Geom (roi_geom_bytes(k) each, 16-byte
// aligned): each valid RoI's geometry, its weights rounded for bfloat16
// levels when bf16_weights is not 0; bitmap (batch * tiles_per_img,
// ceil(batch * rois_per_img / 32)) uint32: bit n of tile t's row is set
// when valid RoI n meets tile t (image * tiles_per_img + tile_base[level] +
// ty * tiles_x[level] + tx).  The bitmap is zeroed on `stream` first.
#define ROI_TILE_KEYS_ENTRY(name, k)                                                      \
  extern "C" int name(const void* rois, const void* valid, void* geo, void* bitmap,       \
                      int batch, int rois_per_img, int bf16_weights, float finest_scale,  \
                      int num_levels, const long long* levels, void* stream) {            \
    return tile_keys<k>(rois, valid, geo, bitmap, batch, rois_per_img, bf16_weights,      \
                        finest_scale, num_levels, levels, stream);                        \
  }

ROI_TILE_KEYS_ENTRY(roi_tile_keys, 7)
ROI_TILE_KEYS_ENTRY(roi_tile_keys_o14, 14)

// g (batch * rois_per_img, k, k, channels), float or bfloat16: the
// cotangent; geo and bitmap: the tile-key entry's output of the same size
// for the same RoIs (with bf16_weights for the bfloat16 entries).
// channels is a multiple of 4 (float) or 8 (bfloat16).  Writes every cell
// of every level gradient.
#define ROI_ALIGN_BWD_ENTRY(name, T, k)                                                   \
  extern "C" int name(const void* g, const void* geo, const void* bitmap, int batch,      \
                      int rois_per_img, int channels, float finest_scale, int num_levels, \
                      const long long* levels, void* stream) {                            \
    return launch_bwd<T, k>(g, geo, bitmap, batch, rois_per_img, channels, finest_scale,  \
                            num_levels, levels, stream);                                  \
  }

ROI_ALIGN_BWD_ENTRY(roi_align_bwd_f32, float, 7)
ROI_ALIGN_BWD_ENTRY(roi_align_bwd_bf16, __nv_bfloat16, 7)
ROI_ALIGN_BWD_ENTRY(roi_align_bwd_f32_o14, float, 14)
ROI_ALIGN_BWD_ENTRY(roi_align_bwd_bf16_o14, __nv_bfloat16, 14)
