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
// Design at 7 x 7 in float32 (the box branch; roi_align_fwd_kernel): one
// block per RoI, 256 threads: along the channels, 64 threads that each load
// 16 bytes (4 channels; one coalesced row of 256 channels per cell), times
// 4 groups that share the 49 bins.  Warp 0 computes the RoI's geometry into
// shared memory first.  Each bin then reads only the cells of its nonzero
// taps (2 x 2 samples, 2 x 2 taps each, on 2-4 distinct rows and columns)
// and accumulates in float32 registers, a column's rows first; the bins of
// one RoI share cells, which L1 serves.  The 14 x 14 body below, launched
// at 7 (H100, 700 W), gave the same bits but was slower at the flagship's
// train shapes (0.141 against 0.121 ms) and faster only at the predict and
// per-image shapes (0.0359 against 0.0446 ms), so float32 keeps this body.
//
// Design at 7 x 7 in bfloat16 (roi_align_fwd_bins_kernel).  The body above
// ran bfloat16 at 27-32% of its bound: about one load in flight a thread
// (a branch on every zero weight of a bin's tap range) and seven warps
// waiting while warp 0 computed the geometry.  Here as many blocks as the
// card holds at once (4 of 256 threads an SM at 64 registers, no spills;
// 528 on 132 SMs) each take a contiguous run of RoIs, and warp 7 folds
// RoI i + 1's taps into the second of two slots while all warps pool RoI
// i, one barrier a RoI.  The taps come straight from each bin's two samples
// in registers (fold_taps: roi_geometry's roundings and sums, no dense
// window of weights), as lists with their counts, so a bin runs the
// straight-line code of its counts (2-4 rows by 2-4 columns) with all of
// its loads in flight before its first FMA: 8 bytes a lane (4 channels, 2
// registers a load; 16-byte lanes spilled and were slower).  Where a block
// pools several RoIs it asks L1 for every line of each RoI's tap window as
// the RoI starts.  The operations per output element are the float32
// body's, in the same order, so the output is the same bits.
// chip_smoke.py in turns with the body above (NVIDIA H100 80GB HBM3,
// 700.00 W), kernel ms:
// flagship predict shapes 0.0164 / 0.0165 against 0.0234 / 0.0232, train
// 0.0585 / 0.0575 against 0.0762 / 0.0764, one image 0.0169 / 0.0170
// against 0.0235 / 0.0236, Mask R-CNN's 2000 box proposals 0.0892 / 0.0880
// against 0.0953 / 0.0950, its 1024 box slots 0.0506 / 0.0503 against
// 0.0659 / 0.0660.  In the same call, not kept: blocks of two RoIs that
// compute both geometries at once (faster at the train and box shapes,
// 0.0566 and 0.0810 ms, slower at the predict and per-image shapes, 0.0197
// and 0.0209); the prefetch for every block (predict 0.0175, per image
// 0.0182) and for none (train 0.0632; it would win at the box shapes,
// 0.0860 and 0.0477, where windows of P2 at stride 4 outgrow L1).  Without
// the 3 x 4, 4 x 3 and 4 x 4 cases, Mask R-CNN's 2000 box proposals (bins
// of up to 4 taps an axis on P2) ran slower than the body above.
//
// Design at 14 x 14 (the mask branch; roi_align_fwd_rows_kernel).  One
// block per RoI left the card idle there: Mask R-CNN's 200 detections made
// 200 blocks on 132 SMs, each walking 196 bins with about one load in
// flight a thread (15% of the bound), and in training 1008 of the 1024
// slots are invalid, whose zeros went out block by block before the 16
// valid RoIs' bins ran as a tail.  So the 14 x 14 body cuts the work by bin
// row: a work item is (valid RoI, bin row py, 256 channels), and a grid of
// as many blocks as the card holds at once (the occupancy times the SMs, 4
// blocks of 64 registers) takes the items in contiguous runs, so that a
// block walks consecutive rows of one RoI (L1 keeps the level rows that
// rows py and py + 1 share).  The blocks find the valid RoIs themselves:
// each counts the valid flags of its threads' slots and scans the counts,
// so that item ranks map to RoIs without a pass before the kernel.  The
// geometry of a run's next two RoIs is computed at once, one warp each
// (roi_geometry, then each bin row's and column's nonzero taps), in the
// block rather than in a pass of its own: the entry point has no scratch
// memory for it, and the batch costs one warp's latency a run.  A row is
// two phases over shared memory.  First the column sums of the bin row:
// for every window column m that some bin weights, t[m, c] = sum_k wy[py,
// k] * level[wy0 + k, wx0 + m, c] over the row's nonzero taps k (at most
// 4), each thread issuing all of its cell's tap loads before the FMAs, into
// a 24 x 256 float32 band (24 KB).  Then each bin sums its nonzero column
// taps of the band, m ascending: acc = fmaf(wx[px, m], t[m, c], acc), and
// stores once.  The operations and their order per output element are
// those of the 7 x 7 body (t over the rows, then the columns), so the
// numbers are the same bits; the band only stops each bin from reloading
// the columns that its neighbours share.  Each cell of the band is loaded
// by one thread per row; staging the level rows in shared memory first
// (TMA) would move the same bytes twice with no reuse inside the row, and
// the 96 KB band of 4 float32 rows would hold an SM to 2 blocks.  Then
// every block zeroes the invalid slots of its stride (slot blockIdx.x,
// blockIdx.x + gridDim.x, ...), 16-byte stores over each slot's contiguous
// bytes, as a memset would: each output byte is written once, and an
// invalid RoI reads nothing but its flag.  What holds it now (PERF.md): not
// its bytes but its latency chains; chip_smoke.py times this kernel on one
// 16-byte vector of channels (the scan, the geometry, the barriers of each
// row, next to no loads), and that run takes most of the full kernel's time.
//
// Both: the levels are read in place (NHWC, unit channel stride; the
// wrapper passes their strides), so there is no stacked copy of the pyramid
// and no geometry pass before the kernel.  No tensor cores: their float32
// path is TF32, which would change the numbers, and each bin is a handful
// of products.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <climits>
#include <type_traits>

#include "roi_geometry.cuh"

namespace {

using namespace roi;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// --- 14 x 14: work items by bin row ---------------------------------------

// nonzero taps of one bin along one axis: each of its kSamples samples has
// two (roi_geometry.cuh), so no bin weights more cells than this
constexpr int kMaxTaps = 2 * kSamples;

// One RoI's nonzero taps per bin row and per bin column, ascending, in
// shared memory beside its geometry, and the window columns that some bin
// weights.
template <int kOut>
struct RowTaps {
  int ny[kOut], ky[kOut][kMaxTaps];
  float ay[kOut][kMaxTaps];
  int nx[kOut], kx[kOut][kMaxTaps];
  float ax[kOut][kMaxTaps];
  int ncols, cols[kWin];
};

// Fills *t from *g (warp 0): lanes 0..kOut-1 list the rows of bin row
// lane, lanes kOut..2kOut-1 the columns of bin column lane - kOut; then
// lane m < kWin marks window column m when a bin weights it.
template <int kOut>
__device__ inline void row_taps(const Geom<kOut>& g, RowTaps<kOut>* t) {
  const int lane = threadIdx.x & 31;
  if (lane < 2 * kOut) {
    const bool along_y = lane < kOut;
    const int o = along_y ? lane : lane - kOut;
    const float* w = along_y ? g.wy[o] : g.wx[o];
    const int lo = along_y ? g.ylo[o] : g.xlo[o];
    const int hi = along_y ? g.yhi[o] : g.xhi[o];
    int* ks = along_y ? t->ky[o] : t->kx[o];
    float* as = along_y ? t->ay[o] : t->ax[o];
    int n = 0;
    for (int k = lo; k <= hi && n < kMaxTaps; ++k) {
      if (w[k] != 0.0f) {
        ks[n] = k;
        as[n] = w[k];
        ++n;
      }
    }
    (along_y ? t->ny : t->nx)[o] = n;
  }
  bool used = false;
  if (lane < kWin) {
    for (int o = 0; o < kOut; ++o) used |= g.wx[o][lane] != 0.0f;
  }
  const unsigned mask = __ballot_sync(0xffffffffu, used);
  if (used) t->cols[__popc(mask & ((1u << lane) - 1u))] = lane;
  if (lane == 0) t->ncols = __popc(mask);
  __syncwarp();
}

constexpr int kGeomSlots = 2;  // RoIs whose geometry a block computes at once
static_assert(sizeof(RowTaps<14>) == 1108, "RowTaps<14> (ops/roi_align_kernel.py)");

template <typename T, int kOut>
__global__ void __launch_bounds__(kThreads, 4)
roi_align_fwd_rows_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                          const Levels L, int n_rois, int rois_per_img, int channels,
                          T* __restrict__ out) {
  constexpr int kW = Pack<T>::kWidth;
  constexpr int kVecs = kRowChannels / kW;  // 16-byte vectors of 256 channels
  constexpr int kPlanes = kW / 4;           // float4s of one vector's column sums
  __shared__ Geom<kOut> geoms[kGeomSlots];
  __shared__ RowTaps<kOut> row_lists[kGeomSlots];
  // the bin row's column sums: band[(m * kPlanes + p) * kVecs + v] holds
  // channels kW * v + 4p .. +3 of window column m
  __shared__ float4 band[kWin * kPlanes * kVecs];
  __shared__ int warp_valid[kWarps];
  __shared__ int slots[kGeomSlots];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // the valid RoIs: thread i counts those of its slots s0..s1-1, and the
  // block scans the counts, so that rank r is found in one thread's slots
  const int per = (n_rois + kThreads - 1) / kThreads;
  const int s0 = min(static_cast<int>(threadIdx.x) * per, n_rois);
  const int s1 = min(s0 + per, n_rois);
  int cnt = 0;
  for (int s = s0; s < s1; ++s) cnt += valid[s] != 0;
  int incl = cnt;
  for (int d = 1; d < 32; d *= 2) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_valid[warp] = incl;
  __syncthreads();
  int first = incl - cnt;  // valid RoIs before slot s0
  int n_valid = 0;
  for (int w = 0; w < kWarps; ++w) {
    first += w < warp ? warp_valid[w] : 0;
    n_valid += warp_valid[w];
  }

  const int chunks = (channels + kRowChannels - 1) / kRowChannels;
  const int parts = kOut * chunks;  // items of one RoI: (256 channels, bin row)
  const int n_items = n_valid * parts;
  const int run = (n_items + gridDim.x - 1) / gridDim.x;
  const int i0 = min(static_cast<int>(blockIdx.x) * run, n_items);
  const int i1 = min(i0 + run, n_items);
  int r0 = -kGeomSlots;  // the rank of geometry slot 0
  for (int item = i0; item < i1; ++item) {
    const int rank = item / parts;
    if (rank >= r0 + kGeomSlots) {  // the next RoIs of the run: one warp each
      r0 = rank;
      const int r1 = min((i1 - 1) / parts + 1, r0 + kGeomSlots);
      for (int r = max(r0, first); r < min(r1, first + cnt); ++r) {
        int left = r - first;
        for (int s = s0; s < s1; ++s) {
          if (valid[s] && left-- == 0) slots[r - r0] = s;
        }
      }
      __syncthreads();
      if (warp < r1 - r0) {
        roi_geometry<sizeof(T) == 2, kOut>(rois, slots[warp], rois_per_img, L, &geoms[warp]);
        row_taps<kOut>(geoms[warp], &row_lists[warp]);
      }
      __syncthreads();
    }
    const Geom<kOut>& g = geoms[rank - r0];
    const RowTaps<kOut>& taps = row_lists[rank - r0];
    const int part = item - rank * parts;
    const int py = part % kOut;
    const int cbase = (part / kOut) * kRowChannels;
    const int vecs = min(kRowChannels, channels - cbase) / kW;
    const Level lv = L.lv[g.level];
    const T* win = static_cast<const T*>(lv.base) + g.img * lv.s_img + g.wy0 * lv.s_row +
                   g.wx0 * lv.s_col + cbase;
    const int ny = taps.ny[py];
    // phase 1: the column sums of bin row py, each cell's tap loads in
    // flight together, then the rows summed in ascending order
    for (int u = threadIdx.x; u < taps.ncols * kVecs; u += kThreads) {
      const int j = u / kVecs;
      const int v = u - j * kVecs;
      if (v >= vecs) continue;
      const int m = taps.cols[j];
      const T* cell = win + m * lv.s_col + kW * v;
      float x[kMaxTaps][kW];
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < ny) Pack<T>::load(cell + taps.ky[py][i] * lv.s_row, x[i]);
      }
      float t[kW] = {};
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < ny) {
          const float a = taps.ay[py][i];
#pragma unroll
          for (int e = 0; e < kW; ++e) t[e] = fmaf(a, x[i][e], t[e]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        band[(m * kPlanes + p) * kVecs + v] =
            make_float4(t[4 * p], t[4 * p + 1], t[4 * p + 2], t[4 * p + 3]);
      }
    }
    __syncthreads();
    // phase 2: each bin of the row over its nonzero columns, m ascending
    T* dst = out + (static_cast<size_t>(slots[rank - r0]) * kOut * kOut + py * kOut) * channels +
             cbase;
    for (int u = threadIdx.x; u < kOut * kVecs; u += kThreads) {
      const int px = u / kVecs;
      const int v = u - px * kVecs;
      if (v >= vecs) continue;
      const int nx = taps.nx[px];
      float acc[kW] = {};
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < nx) {
          const float c = taps.ax[px][i];
          const int m = taps.kx[px][i];
#pragma unroll
          for (int p = 0; p < kPlanes; ++p) {
            const float4 b = band[(m * kPlanes + p) * kVecs + v];
            acc[4 * p] = fmaf(c, b.x, acc[4 * p]);
            acc[4 * p + 1] = fmaf(c, b.y, acc[4 * p + 1]);
            acc[4 * p + 2] = fmaf(c, b.z, acc[4 * p + 2]);
            acc[4 * p + 3] = fmaf(c, b.w, acc[4 * p + 3]);
          }
        }
      }
      Pack<T>::store(dst + px * channels + kW * v, acc);
    }
    __syncthreads();  // the band, the geometry and the slots are rewritten next
  }

  // the invalid slots of this block's stride, zeroed with 16-byte stores
  const int slot_vecs = kOut * kOut * channels / kW;
  for (int s = blockIdx.x; s < n_rois; s += gridDim.x) {
    if (valid[s]) continue;
    uint4* z = reinterpret_cast<uint4*>(out + static_cast<size_t>(s) * kOut * kOut * channels);
#pragma unroll 4
    for (int i = threadIdx.x; i < slot_vecs; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// --- 7 x 7 in bfloat16: bins with fixed trip counts, runs of RoIs -------

// 8 bytes of bfloat16, a lane's 4 channels: loaded raw, widened to float32
// after the load (all of a bin's loads in flight at 2 registers each),
// stored rounded to nearest even once.
struct Pack8 {
  static constexpr int kWidth = 4;
  using Raw = uint2;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint2*>(p));
  }
  // channel 2i is the low half of word i (memory order)
  __device__ static void widen(const Raw& r, float* v) {
    v[0] = __uint_as_float(r.x << 16);
    v[1] = __uint_as_float(r.x & 0xffff0000u);
    v[2] = __uint_as_float(r.y << 16);
    v[3] = __uint_as_float(r.y & 0xffff0000u);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                                 __floats2bfloat162_rn(v[2], v[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
  }
};

// One RoI's nonzero taps per bin row and per bin column, ascending, as
// element offsets from its window origin (row k: k * s_row; column m:
// m * s_col) with their weights; lists shorter than kMaxTaps are padded
// with offset 0 and weight 0, which no bin reads.
template <int kOut>
struct alignas(16) BinTaps {
  int oy[kOut][kMaxTaps];
  float ay[kOut][kMaxTaps];
  int ox[kOut][kMaxTaps];
  float ax[kOut][kMaxTaps];
  int ny[kOut], nx[kOut];
  const void* win;  // the window origin in the RoI's level and image
  int valid;
  int y_lo, y_hi, x_lo, x_hi;  // the window rows and columns its taps read
  int s_row, s_col;            // the level's element strides
};

// The window offsets fit in int: 24 rows and columns of every level.
inline bool taps_fit_int(const Levels& L) {
  for (int l = 0; l < L.n; ++l) {
    if (kWin * L.lv[l].s_row > INT_MAX || kWin * L.lv[l].s_col > INT_MAX) return false;
  }
  return true;
}

// The nonzero taps of one bin along one axis, ascending: the pool fold of
// roi_geometry (roi_geometry.cuh) for the bin's two samples, written out
// for their at most four cells, in bfloat16's roundings.  Each cell starts
// at zero and adds its taps of the two samples (a second tap only where its
// float32 weight is not zero), each weight rounded to bfloat16 first and
// halved (by kHalf: the bits of roi_geometry's division by kSamples), and
// each sum is rounded again.  A cell gets at most one tap of each sample,
// and 0 + x + y == 0 + y + x in IEEE arithmetic, so taking the sample with
// the lower cell first (a reversed RoI's samples descend) gives
// roi_geometry's sums.  Writes the cells times `step` and the weights, zero
// weights left out, to offs[] and ws[]; returns the count and the first and
// last cell in *first, *last.
__device__ inline int fold_taps(const Tap& s0, const Tap& s1, int step, int* offs, float* ws,
                                int* first, int* last) {
  const Tap& a = s1.k < s0.k ? s1 : s0;
  const Tap& b = s1.k < s0.k ? s0 : s1;
  auto weight = [](float raw) { return __fmul_rn(round_bf16(raw), kHalf); };
  const bool a1 = a.w1 > 0.0f;
  const bool b1 = b.w1 > 0.0f;
  // cells a.k and a.k + 1, then b's two where they are not a's (b.k >= a.k)
  int cell[4];
  float sum[4];
  bool used[4];
  cell[0] = a.k;
  sum[0] = __fadd_rn(0.0f, weight(a.w0));
  used[0] = true;
  cell[1] = a.k + 1;
  sum[1] = a1 ? __fadd_rn(0.0f, weight(a.w1)) : 0.0f;
  used[1] = a1;
  if (b.k == a.k) {
    sum[0] = __fadd_rn(sum[0], weight(b.w0));
    if (b1) sum[1] = __fadd_rn(sum[1], weight(b.w1));
    used[1] = a1 || b1;
    used[2] = used[3] = false;
    cell[2] = cell[3] = 0;
    sum[2] = sum[3] = 0.0f;
  } else if (b.k == a.k + 1) {
    sum[1] = __fadd_rn(sum[1], weight(b.w0));
    used[1] = true;
    cell[2] = b.k + 1;
    sum[2] = b1 ? __fadd_rn(0.0f, weight(b.w1)) : 0.0f;
    used[2] = b1;
    used[3] = false;
    cell[3] = 0;
    sum[3] = 0.0f;
  } else {
    cell[2] = b.k;
    sum[2] = __fadd_rn(0.0f, weight(b.w0));
    used[2] = true;
    cell[3] = b.k + 1;
    sum[3] = b1 ? __fadd_rn(0.0f, weight(b.w1)) : 0.0f;
    used[3] = b1;
  }
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float w = round_bf16(sum[i]);
    if (used[i] && w != 0.0f) {
      offs[n] = cell[i] * step;
      ws[n] = w;
      *first = min(*first, cell[i]);
      *last = max(*last, cell[i]);
      ++n;
    }
  }
  return n;
}

// Fills *t for RoI n (one warp), the weights rounded for bfloat16: lanes
// 0..kOut-1 list the rows of bin row lane and lanes kOut..2kOut-1 the
// columns of bin column lane - kOut, ascending, the zero weights left out,
// straight from the bin's two samples (fold_taps) without the dense Geom;
// the same weights as roi_geometry's.  An invalid RoI gets only its flag.
template <int kOut>
__device__ inline void bin_taps(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                                int n, int rois_per_img, const Levels& L, BinTaps<kOut>* t) {
  const int lane = threadIdx.x & 31;
  const int live = valid[n];
  if (live) {
    const Window win = roi_window<kOut>(rois + 4 * static_cast<size_t>(n), L);
    const Level& lv = L.lv[win.level];
    const bool row_lane = lane < kOut;
    const bool col_lane = lane >= kOut && lane < 2 * kOut;
    int first = kWin;
    int last = -1;
    if (row_lane || col_lane) {
      const int o = row_lane ? lane : lane - kOut;
      const float start = row_lane ? win.y1 : win.x1;
      const float bin = row_lane ? win.bin_h : win.bin_w;
      const float origin = static_cast<float>(row_lane ? win.wy0 : win.wx0);
      const float hi = row_lane ? win.hi_y : win.hi_x;
      const Tap a = sample_tap(start, bin, origin, hi, o * kSamples);
      const Tap b = sample_tap(start, bin, origin, hi, o * kSamples + 1);
      int* offs = row_lane ? t->oy[o] : t->ox[o];
      float* as = row_lane ? t->ay[o] : t->ax[o];
      int k = fold_taps(a, b, static_cast<int>(row_lane ? lv.s_row : lv.s_col), offs, as, &first,
                        &last);
      (row_lane ? t->ny : t->nx)[o] = k;
      for (; k < kMaxTaps; ++k) {
        offs[k] = 0;
        as[k] = 0.0f;
      }
    }
    // the span of window rows and columns that the taps read
    int y_lo = row_lane ? first : kWin, y_hi = row_lane ? last : -1;
    int x_lo = col_lane ? first : kWin, x_hi = col_lane ? last : -1;
    for (int d = 16; d > 0; d /= 2) {
      y_lo = min(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, d));
      y_hi = max(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, d));
      x_lo = min(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, d));
      x_hi = max(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, d));
    }
    if (lane == 0) {
      t->win = static_cast<const __nv_bfloat16*>(lv.base) + (n / rois_per_img) * lv.s_img +
               win.wy0 * lv.s_row + win.wx0 * lv.s_col;
      t->y_lo = y_lo;
      t->y_hi = y_hi;
      t->x_lo = x_lo;
      t->x_hi = x_hi;
      t->s_row = static_cast<int>(lv.s_row);
      t->s_col = static_cast<int>(lv.s_col);
    }
  }
  if (lane == 0) t->valid = live;
  __syncwarp();
}

// One bin on one thread's kW channels at `cell` (the window origin plus
// the thread's channels): t = sum over the bin's rows k of wy * x, rows
// ascending, for each of its columns m ascending, acc = fmaf(wx, t, acc).
// kNy x kNx taps, every load issued before the first FMA.
template <int kNy, int kNx>
__device__ inline void pool_taps(const __nv_bfloat16* cell, const int* oy, const float* ay,
                                 const int* ox, const float* ax, float* acc) {
  using P = Pack8;
  constexpr int kW = P::kWidth;
  typename P::Raw raw[kNx][kNy];
#pragma unroll
  for (int j = 0; j < kNx; ++j) {
#pragma unroll
    for (int i = 0; i < kNy; ++i) raw[j][i] = P::load(cell + oy[i] + ox[j]);
  }
#pragma unroll
  for (int j = 0; j < kNx; ++j) {
    float t[kW] = {};
#pragma unroll
    for (int i = 0; i < kNy; ++i) {
      float x[kW];
      P::widen(raw[j][i], x);
#pragma unroll
      for (int e = 0; e < kW; ++e) t[e] = fmaf(ay[i], x[e], t[e]);
    }
#pragma unroll
    for (int e = 0; e < kW; ++e) acc[e] = fmaf(ax[j], t[e], acc[e]);
  }
}

// The same for any other ny, nx <= kMaxTaps (a bin clamped at a level's
// edge to one tap, or 2 x 4 and 4 x 2): one column's row loads in flight
// at a time.
__device__ inline void pool_taps_any(const __nv_bfloat16* cell, const int* oy, const float* ay,
                                     int ny, const int* ox, const float* ax, int nx, float* acc) {
  using P = Pack8;
  constexpr int kW = P::kWidth;
#pragma unroll
  for (int j = 0; j < kMaxTaps; ++j) {
    if (j >= nx) break;
    typename P::Raw raw[kMaxTaps];
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      if (i < ny) raw[i] = P::load(cell + oy[i] + ox[j]);
    }
    float t[kW] = {};
#pragma unroll
    for (int i = 0; i < kMaxTaps; ++i) {
      if (i < ny) {
        float x[kW];
        P::widen(raw[i], x);
#pragma unroll
        for (int e = 0; e < kW; ++e) t[e] = fmaf(ay[i], x[e], t[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < kW; ++e) acc[e] = fmaf(ax[j], t[e], acc[e]);
  }
}

constexpr int kTapsWarp = kWarps - 1;  // the warp that lists the next RoI's taps

// Asks for every 128-byte line of the window cells that RoI *t reads (its
// tap rows by its tap columns, all channels) to be brought into L1, thread
// `tid` of `threads` a share.
template <int kOut>
__device__ inline void prefetch_window(const BinTaps<kOut>& t, int channels, int tid,
                                       int threads) {
  constexpr int kBytes = static_cast<int>(sizeof(__nv_bfloat16));
  const int lines = (channels * kBytes + 127) / 128;
  const int cols = t.x_hi - t.x_lo + 1;
  const int per_row = cols * lines;
  const int total = (t.y_hi - t.y_lo + 1) * per_row;
  const char* win = static_cast<const char*>(t.win) +
                    (static_cast<long long>(t.y_lo) * t.s_row + t.x_lo * t.s_col) * kBytes;
  for (int i = tid; i < total; i += threads) {
    const int r = i / per_row;
    const int rest = i - r * per_row;
    const int c = rest / lines;
    const char* p = win + (static_cast<long long>(r) * t.s_row + c * t.s_col) * kBytes +
                    (rest - c * lines) * 128;
    asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
  }
}

template <int kOut>
__global__ void __launch_bounds__(kThreads, 4)
roi_align_fwd_bins_kernel(const float* __restrict__ rois, const uint8_t* __restrict__ valid,
                          const Levels L, int n_rois, int rois_per_img, int channels,
                          __nv_bfloat16* __restrict__ out) {
  using T = __nv_bfloat16;
  constexpr int kW = Pack8::kWidth;
  __shared__ BinTaps<kOut> taps[2];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int run = (n_rois + gridDim.x - 1) / gridDim.x;
  const int n0 = min(static_cast<int>(blockIdx.x) * run, n_rois);
  const int n1 = min(n0 + run, n_rois);
  if (n0 >= n1) return;  // the same for the whole block, before any barrier
  const int vecs = channels / kW;
  const bool prefetch = n1 - n0 > 1;  // (one RoI: measured slower with it)

  if (warp == kTapsWarp) bin_taps<kOut>(rois, valid, n0, rois_per_img, L, &taps[0]);
  __syncthreads();
  for (int n = n0; n < n1; ++n) {
    const int slot = (n - n0) & 1;
    const BinTaps<kOut>& tp = taps[slot];
    if (prefetch && tp.valid) prefetch_window<kOut>(tp, channels, threadIdx.x, kThreads);
    // the next RoI's taps into the other slot, while the others pool this one
    if (warp == kTapsWarp && n + 1 < n1) {
      bin_taps<kOut>(rois, valid, n + 1, rois_per_img, L, &taps[slot ^ 1]);
    }
    if (tp.valid) {
      for (int v0 = 0; v0 < vecs; v0 += 32) {  // 32 lanes of channels at a time
        for (int b = warp; b < kOut * kOut; b += kWarps) {
          const int py = b / kOut;
          const int px = b - py * kOut;
          const int4 oy4 = *reinterpret_cast<const int4*>(tp.oy[py]);
          const float4 ay4 = *reinterpret_cast<const float4*>(tp.ay[py]);
          const int4 ox4 = *reinterpret_cast<const int4*>(tp.ox[px]);
          const float4 ax4 = *reinterpret_cast<const float4*>(tp.ax[px]);
          const int oy[kMaxTaps] = {oy4.x, oy4.y, oy4.z, oy4.w};
          const float ay[kMaxTaps] = {ay4.x, ay4.y, ay4.z, ay4.w};
          const int ox[kMaxTaps] = {ox4.x, ox4.y, ox4.z, ox4.w};
          const float ax[kMaxTaps] = {ax4.x, ax4.y, ax4.z, ax4.w};
          const int ny = tp.ny[py];
          const int nx = tp.nx[px];
          const int v = v0 + lane;
          if (v >= vecs) continue;
          const T* cell = static_cast<const T*>(tp.win) + kW * v;
          float acc[kW] = {};
          switch (ny * 8 + nx) {  // the same for the whole warp
            case 2 * 8 + 2: pool_taps<2, 2>(cell, oy, ay, ox, ax, acc); break;
            case 2 * 8 + 3: pool_taps<2, 3>(cell, oy, ay, ox, ax, acc); break;
            case 3 * 8 + 2: pool_taps<3, 2>(cell, oy, ay, ox, ax, acc); break;
            case 3 * 8 + 3: pool_taps<3, 3>(cell, oy, ay, ox, ax, acc); break;
            case 3 * 8 + 4: pool_taps<3, 4>(cell, oy, ay, ox, ax, acc); break;
            case 4 * 8 + 3: pool_taps<4, 3>(cell, oy, ay, ox, ax, acc); break;
            case 4 * 8 + 4: pool_taps<4, 4>(cell, oy, ay, ox, ax, acc); break;
            default: pool_taps_any(cell, oy, ay, ny, ox, ax, nx, acc);
          }
          Pack8::store(out + (static_cast<size_t>(n) * kOut * kOut + b) * channels + kW * v, acc);
        }
      }
    } else {  // zeros, each byte once
      T* dst = out + static_cast<size_t>(n) * kOut * kOut * channels;
      const float zero[kW] = {};
      for (int b = warp; b < kOut * kOut; b += kWarps) {
        for (int v = lane; v < vecs; v += 32) Pack8::store(dst + b * channels + kW * v, zero);
      }
    }
    __syncthreads();  // the slot is rewritten two RoIs on
  }
}

// A grid of one block per work item up to as many as the card holds at
// once, for `kernel` in blocks of kThreads.  plan[0..3]: grid, block,
// dynamic shared memory (bytes), blocks an SM holds.  The occupancy and the
// SM count are asked once per kernel, on the device current at its first
// launch, and kept in atomics (callers on several threads store the same
// answer); the grid only sizes the runs, so no result depends on it.
template <auto kernel>
cudaError_t card_plan(long long items, int* plan) {
  static std::atomic<int> cached_per_sm{0};
  static std::atomic<int> cached_sms{0};
  int per_sm = cached_per_sm.load();
  int sms = cached_sms.load();
  if (per_sm == 0 || sms == 0) {
    int device = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err == cudaSuccess) err = cudaGetDevice(&device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    cached_per_sm.store(per_sm);
    cached_sms.store(sms);
  }
  const long long most = static_cast<long long>(sms) * per_sm;
  plan[0] = static_cast<int>(items < most ? items : most);
  plan[1] = kThreads;
  plan[2] = 0;
  plan[3] = per_sm;
  return cudaSuccess;
}

// The 14 x 14 body's launch: items of (valid RoI, bin row, 256 channels),
// counted over all slots.
template <typename T, int kOut>
cudaError_t rows_plan(int n_rois, int channels, int* plan) {
  return card_plan<roi_align_fwd_rows_kernel<T, kOut>>(
      static_cast<long long>(n_rois) * kOut * ((channels + kRowChannels - 1) / kRowChannels),
      plan);
}

// The 7 x 7 bfloat16 body's launch: one block per RoI up to the blocks the
// card holds at once, each taking a run of RoIs.
template <int kOut>
cudaError_t bins_plan(int n_rois, int* plan) {
  return card_plan<roi_align_fwd_bins_kernel<kOut>>(n_rois, plan);
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
  const int n = batch * rois_per_img;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rois);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  int plan[4];
  if constexpr (kOut == 14) {
    const cudaError_t err = rows_plan<T, kOut>(n, channels, plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_align_fwd_rows_kernel<T, kOut><<<plan[0], plan[1], plan[2], s>>>(
        r, v, L, n, rois_per_img, channels, static_cast<T*>(out));
  } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    if (!taps_fit_int(L)) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = bins_plan<kOut>(n, plan);
    if (err != cudaSuccess) return static_cast<int>(err);
    roi_align_fwd_bins_kernel<kOut><<<plan[0], plan[1], plan[2], s>>>(
        r, v, L, n, rois_per_img, channels, static_cast<T*>(out));
  } else {
    roi_align_fwd_kernel<T, kOut><<<n, kThreads, 0, s>>>(r, v, L, rois_per_img, channels,
                                                        static_cast<T*>(out));
  }
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

// The launch an entry point makes for batch * rois_per_img RoIs of
// `channels`: plan[0..3] = grid, block, dynamic shared memory (bytes),
// blocks an SM holds (0 where the grid does not depend on it).  out_size 7
// or 14, bf16 0 or 1; returns a CUDA error code, 0 on success.
extern "C" int roi_align_fwd_plan(int out_size, int bf16, int n_rois, int channels, int* plan) {
  if (out_size == 14) {
    return static_cast<int>(bf16 ? rows_plan<__nv_bfloat16, 14>(n_rois, channels, plan)
                                 : rows_plan<float, 14>(n_rois, channels, plan));
  }
  if (out_size != 7) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) return static_cast<int>(bins_plan<7>(n_rois, plan));
  plan[0] = n_rois;
  plan[1] = kThreads;
  plan[2] = 0;
  plan[3] = 0;
  return 0;
}
