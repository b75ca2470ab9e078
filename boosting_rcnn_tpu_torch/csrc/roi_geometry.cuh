// RoIAlign geometry shared by the forward (roi_align_fwd.cu) and gradient
// (roi_align_bwd.cu) kernels: the pyramid level of a RoI, its 24-cell window
// in that level, and the two bilinear taps of each of its 2 * kOut sample
// positions per axis (kOut bins x 2 samples).  The pooled size kOut is a
// template parameter: 7 for the box branch, 14 for the mask branch, the two
// sizes the JAX package calls its Pallas kernels with.
//
// It computes, in the same order of IEEE float32 operations, what the plain
// version computes in PyTorch (boosting_rcnn_tpu_torch/ops/roi_align.py:
// `map_roi_levels`, `roi_window`, `sample_taps`), which is the port of the
// JAX package's `_batched_geometry` (boosting_rcnn_tpu/ops/
// pallas_roi_align.py:690) and `_interp_matrix` (boosting_rcnn_tpu/ops/
// roi_align.py:195), documented deviations included: 2 samples per bin
// axis, samples clamped to the window, the window origin
// wy0 = min(max(floor(y1), 0), max(H - 24, 0)) and the last usable window
// row hi = min(H - 1 - wy0, 23) (columns alike, with the window width
// min(24, widest level)).  Every product and sum goes through the _rn
// intrinsics so that nvcc cannot contract a * b + c into one rounding where
// PyTorch rounds twice: the level is a floor of log2 and the window origin
// a floor, and a flip in either moves the RoI.
//
// A sample at window coordinate rel in [0, hi] has the nonzero taps
// k = floor(rel) (weight 1 - (rel - k)) and k + 1 (weight rel - k, zero
// when rel is whole); both lie inside the level and inside the window.
//
// For a bfloat16 pyramid the weights take the Pallas kernels' roundings
// (boosting_rcnn_tpu/ops/pallas_roi_align.py:797 and :740): each tap weight
// rounded to bfloat16, each bin's two samples averaged in float32 and the
// mean rounded to bfloat16 again (plain mirror: ops/roi_align.py,
// `fold_pool_rounded`).  Both kernels then sum in float32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace roi {

constexpr int kSamples = 2;              // samples per bin axis
constexpr int kWin = 24;                 // window rows (and widest window)
constexpr int kMaxLevels = 5;
constexpr int kTile = 8;                 // gradient tile: kTile x kTile cells
constexpr int kTilesPerAxis = 4;         // a 24-cell span meets at most 4 tiles
constexpr int kMaxTiles = kTilesPerAxis * kTilesPerAxis;

// One route level of the pyramid, NHWC with unit channel stride: element
// (b, y, x, c) is base[b * s_img + y * s_row + x * s_col + c], of the
// kernel's element type (float or __nv_bfloat16).
struct Level {
  void* base;
  int h, w;
  long long s_img, s_row, s_col;
};

// The route levels, passed to the kernels by value.  Tiles of level l in
// one image are numbered tile_base[l] + ty * tiles_x[l] + tx; image b's
// tiles follow image b - 1's.
struct Levels {
  Level lv[kMaxLevels];
  float inv_stride[kMaxLevels];
  int n;                // route levels
  int win_w;            // window width: min(24, widest level)
  float finest_scale;
  int tile_base[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tiles_per_img;
};

// The window of one RoI: level, origin (level cells), the RoI's start and
// bin size in level cells, and the last usable window row and column.
struct Window {
  int level, wy0, wx0;
  float y1, x1, bin_h, bin_w, hi_y, hi_x;
};

// The two taps of one sample: window cells k and k + 1, weights w0, w1.
struct Tap {
  int k;
  float w0, w1;
};

// What both kernels keep of a RoI in shared memory: its pool-folded
// interpolation weights over the window (the mean of each bin's two
// samples) and, per bin, the first and last window cell with a nonzero
// weight.  16-byte aligned and sized, so that blocks copy it as int4:
// 1488 bytes at kOut = 7, 2944 at 14.
template <int kOut>
struct alignas(16) Geom {
  int n, img, level, wy0, wx0;
  int ylo[kOut], yhi[kOut], xlo[kOut], xhi[kOut];
  float wy[kOut][kWin], wx[kOut][kWin];
  int pad[3];
};
template <int kOut>
constexpr int kGeomVecs = static_cast<int>(sizeof(Geom<kOut>) / 16);
static_assert(sizeof(Geom<7>) == 1488 && sizeof(Geom<14>) == 2944, "Geom sizes");
static_assert(sizeof(Geom<7>) % 16 == 0 && sizeof(Geom<14>) % 16 == 0, "Geom is copied as int4");

__host__ __device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

template <int kOut>
__device__ inline Window roi_window(const float* roi, const Levels& L) {
  const float bw = fmaxf(__fsub_rn(roi[2], roi[0]), 0.0f);
  const float bh = fmaxf(__fsub_rn(roi[3], roi[1]), 0.0f);
  const float size = __fsqrt_rn(__fmul_rn(bw, bh));
  float lvl = floorf(log2f(__fadd_rn(__fdiv_rn(size, L.finest_scale), 1e-6f)));
  lvl = fminf(fmaxf(lvl, 0.0f), static_cast<float>(L.n - 1));
  Window g;
  g.level = clampi(static_cast<int>(lvl), 0, L.n - 1);  // NaN boxes stay in range
  const float s = L.inv_stride[g.level];
  g.x1 = __fsub_rn(__fmul_rn(roi[0], s), 0.5f);
  g.y1 = __fsub_rn(__fmul_rn(roi[1], s), 0.5f);
  g.bin_w = __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(roi[2], s), 0.5f), g.x1),
                      static_cast<float>(kOut));
  g.bin_h = __fdiv_rn(__fsub_rn(__fsub_rn(__fmul_rn(roi[3], s), 0.5f), g.y1),
                      static_cast<float>(kOut));
  const int h = L.lv[g.level].h;
  const int w = L.lv[g.level].w;
  g.wy0 = min(max(static_cast<int>(floorf(g.y1)), 0), max(h - kWin, 0));
  g.wx0 = min(max(static_cast<int>(floorf(g.x1)), 0), max(w - L.win_w, 0));
  g.hi_y = fminf(static_cast<float>(h - 1 - g.wy0), static_cast<float>(kWin - 1));
  g.hi_x = fminf(static_cast<float>(w - 1 - g.wx0), static_cast<float>(L.win_w - 1));
  return g;
}

// Sample j (0..2 * kOut - 1) along one axis: position start + frac_j * bin, frac_j =
// j / 2 + (j % 2 + 0.5) / 2, relative to the window origin, clamped to
// [0, hi].
// Halving rounds the same real number as dividing by kSamples = 2 does, so
// it gives the same bits, without the division's slow-path call.
constexpr float kHalf = 1.0f / kSamples;
static_assert(kSamples == 2, "kHalf is exact");

__device__ inline Tap sample_tap(float start, float bin, float origin, float hi, int j) {
  const float frac = __fadd_rn(static_cast<float>(j / kSamples),
                               __fmul_rn(__fadd_rn(static_cast<float>(j % kSamples), 0.5f), kHalf));
  const float pos = __fadd_rn(start, __fmul_rn(frac, bin));
  const float rel = fminf(fmaxf(__fsub_rn(pos, origin), 0.0f), hi);
  Tap t;
  t.k = clampi(static_cast<int>(floorf(rel)), 0, kWin - 1);
  t.w0 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(rel, static_cast<float>(t.k)))), 0.0f);
  t.w1 = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(rel, static_cast<float>(t.k + 1)))), 0.0f);
  if (t.k + 1 >= kWin) t.w1 = 0.0f;
  return t;
}

__device__ inline float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Fills *g for RoI n (row n of rois (N, 4), image n / rois_per_img).  Called
// by all 32 lanes of one warp; lanes 0..kOut-1 fold the rows of the kOut y
// bins, lanes kOut..2*kOut-1 the columns of the kOut x bins, each adding
// its bin's two samples in order, so the folded weights are exactly
// (w_a + w_b) / 2.  With kBf16Weights, w_a and w_b are rounded to bfloat16
// first and the folded weight after.
template <bool kBf16Weights, int kOut>
__device__ inline void roi_geometry(const float* __restrict__ rois, int n, int rois_per_img,
                                    const Levels& L, Geom<kOut>* g) {
  static_assert(2 * kOut <= 32, "one lane per bin and axis");
  const int lane = threadIdx.x & 31;
  const Window win = roi_window<kOut>(rois + 4 * static_cast<size_t>(n), L);
  float* wflat = &g->wy[0][0];
  for (int i = lane; i < 2 * kOut * kWin; i += 32) wflat[i] = 0.0f;
  __syncwarp();
  if (lane < 2 * kOut) {
    const bool along_y = lane < kOut;
    const int o = along_y ? lane : lane - kOut;
    float* row = along_y ? g->wy[o] : g->wx[o];
    int lo = kWin;
    int hi = -1;
    for (int s = 0; s < kSamples; ++s) {
      const int j = o * kSamples + s;
      const Tap t = along_y
          ? sample_tap(win.y1, win.bin_h, static_cast<float>(win.wy0), win.hi_y, j)
          : sample_tap(win.x1, win.bin_w, static_cast<float>(win.wx0), win.hi_x, j);
      const float w0 = kBf16Weights ? round_bf16(t.w0) : t.w0;
      const float w1 = kBf16Weights ? round_bf16(t.w1) : t.w1;
      row[t.k] = __fadd_rn(row[t.k], __fdiv_rn(w0, static_cast<float>(kSamples)));
      if (t.w1 > 0.0f) {
        row[t.k + 1] = __fadd_rn(row[t.k + 1], __fdiv_rn(w1, static_cast<float>(kSamples)));
      }
      lo = min(lo, t.k);
      hi = max(hi, t.w1 > 0.0f ? t.k + 1 : t.k);
    }
    if (kBf16Weights) {
      for (int k = lo; k <= hi; ++k) row[k] = round_bf16(row[k]);
    }
    (along_y ? g->ylo : g->xlo)[o] = lo;
    (along_y ? g->yhi : g->xhi)[o] = hi;
  }
  if (lane == 0) {
    g->n = n;
    g->img = n / rois_per_img;
    g->level = win.level;
    g->wy0 = win.wy0;
    g->wx0 = win.wx0;
  }
  __syncwarp();
}

// Fills the level descriptors from a host array of 7 int64 per route level:
// base pointer (a device address; 0 where only the shape is used), height,
// width, the element strides of the image, row and column, and the
// level's stride in pixels (1 / stride is rounded to float32 from double,
// as the plain version computes it).  Returns false for what the kernels
// do not take: no level or more than kMaxLevels, a level without cells, a
// stride or base that breaks 16-byte alignment for elements of elem_bytes.
inline bool fill_levels(Levels* L, int num_levels, const long long* desc, float finest_scale,
                        int elem_bytes) {
  if (num_levels < 1 || num_levels > kMaxLevels) return false;
  L->n = num_levels;
  L->finest_scale = finest_scale;
  int widest = 0;
  int tiles = 0;
  for (int l = 0; l < kMaxLevels; ++l) {
    Level& lv = L->lv[l];
    L->tile_base[l] = tiles;
    if (l >= num_levels) {
      lv = Level{nullptr, 0, 0, 0, 0, 0};
      L->inv_stride[l] = 0.0f;
      L->tiles_x[l] = 0;
      continue;
    }
    const long long* d = desc + 7 * l;
    lv.base = reinterpret_cast<void*>(static_cast<uintptr_t>(d[0]));
    lv.h = static_cast<int>(d[1]);
    lv.w = static_cast<int>(d[2]);
    lv.s_img = d[3];
    lv.s_row = d[4];
    lv.s_col = d[5];
    if (lv.h < 1 || lv.w < 1 || d[6] < 1) return false;
    if ((lv.s_img * elem_bytes) % 16 || (lv.s_row * elem_bytes) % 16 ||
        (lv.s_col * elem_bytes) % 16) {
      return false;
    }
    if (reinterpret_cast<uintptr_t>(lv.base) % 16) return false;
    L->inv_stride[l] = static_cast<float>(1.0 / static_cast<double>(d[6]));
    widest = widest > lv.w ? widest : lv.w;
    L->tiles_x[l] = (lv.w + kTile - 1) / kTile;
    tiles += L->tiles_x[l] * ((lv.h + kTile - 1) / kTile);
  }
  L->win_w = widest < kWin ? widest : kWin;
  L->tiles_per_img = tiles;
  return true;
}

// 16 bytes of one element type as float32 values: 4 float channels, or 8
// bfloat16 channels in memory order (channel 2i is the low half of the
// i-th __nv_bfloat162).  Loads go through the read-only cache; stores
// round to nearest even once.
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int kWidth = 4;
  __device__ static void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 x;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = x;
  }
};

}  // namespace roi
